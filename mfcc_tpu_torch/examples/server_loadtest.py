"""Loopback load test: N synthetic REAL-TIME clients against FeatureServer.

The counterpart of the JAX package's ``examples/server_loadtest.py``.
Measures the server AS a server: sustained frames/s, per-chunk reply
latency (p50/p99), and stepper-loop occupancy (time in the per-slot Python
gather vs the batched device step), with every client pacing chunk-sized
sends at the real-time rate (C/16000 s period).

    python -m mfcc_tpu_torch.examples.server_loadtest --streams 256 --seconds 8
    python -m mfcc_tpu_torch.examples.server_loadtest --streams 64 --backend cpu
    python -m mfcc_tpu_torch.examples.server_loadtest --streams 112 \
        --seconds 4 --trace-out trace/

One sender thread paces all sockets; one selector-driven reader drains
replies, so the harness itself scales to hundreds of connections.  The
client side is ``run_clients``, which any server address can be driven
with; it returns what each client sent and received.

``--trace-out DIR`` turns on the server's span ring and starts
``torch.profiler`` before the server exists (started later, it records
none of the server threads' launches); DIR gets ``timeline.json`` (the
profiler's trace with the server's spans, one clock: load it in Perfetto)
and ``server.json`` (the spans alone), and the run prints the card's
longest idle gaps in the load, each with the share of it that each server
thread's phases cover.
"""

import argparse
import contextlib
import json
import os
import selectors
import socket
import threading
import time

import numpy as np

# spans the ring keeps with --trace-out: a chunk leaves ~5 (its recv, wait
# in the slot, encode, send, path) and a step ~9, so 8 s of 1,024 streams
TRACE_CAPACITY = 1 << 20
SERVER_THREADS = ("stepper", "delivery", "reader")
# the profiler's Chrome-trace categories of the card's own work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def client_signal(chunk: int) -> np.ndarray:
    """The one chunk of int16 samples every client sends, over and over
    (per-chunk send cost is what matters; values only need to be
    feature-realistic)."""
    rng = np.random.default_rng(0)
    t = np.arange(chunk) / 16000.0
    sig = np.clip(8000 * np.sin(2 * np.pi * 700 * t)
                  + rng.integers(-3000, 3000, chunk), -32768, 32767)
    return sig.astype(np.int16)


def run_clients(host: str, port: int, n_streams: int, chunk: int,
                seconds: float, ncep: int, samplerate: int = 16000) -> dict:
    """Drive ``n_streams`` loopback clients against a FeatureServer for
    ``seconds``: each sends ``client_signal(chunk)`` as sample words once a
    chunk period (no reset word: the server resets a fresh connection); a
    send that would block is kept and finished first on the next period, so
    each client's stream is the signal repeated.  Then each client shuts
    its write side and reads the server's last frames (the flush of its
    partial chunk) until the server closes.  Returns ``sent`` (bytes each
    client sent), ``received`` (the bytes each got back, the flush's
    included), ``in_window`` (the number of those bytes received within
    ``seconds``), ``elapsed``,
    ``latencies`` (seconds from a client's last send to each reply that
    completed a frame of ``ncep`` cepstra), ``missed`` (periods the sender
    fell a whole period behind), ``period`` and ``connect_s`` (the seconds
    the clients took to connect)."""
    from mfcc_tpu_torch.io import transport

    payload = transport.encode_stream(client_signal(chunk),
                                      reset_first=False
                                      ).astype("<u4").tobytes()
    t_connect = time.perf_counter()
    socks = []
    for _ in range(n_streams):
        c = socket.create_connection((host, port))
        c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        c.setblocking(False)
        socks.append(c)
    connect_s = time.perf_counter() - t_connect
    sent = [0] * n_streams
    backlog = [b""] * n_streams
    last_send = [None] * n_streams
    received = [bytearray() for _ in range(n_streams)]
    latencies = []
    stop = threading.Event()
    period = chunk / samplerate
    missed = [0]

    def sender():
        nxt = time.perf_counter()
        while not stop.is_set():
            now = time.perf_counter()
            if now < nxt:
                time.sleep(min(nxt - now, 0.005))
                continue
            if now - nxt > period:          # fell behind a full period
                missed[0] += 1
            for k, c in enumerate(socks):
                data = backlog[k] + payload
                try:
                    n = c.send(data)
                except (BlockingIOError, OSError):
                    n = 0
                sent[k] += n
                backlog[k] = data[n:]
                if n:
                    last_send[k] = now
            nxt += period

    def reader():
        sel = selectors.DefaultSelector()
        for k, c in enumerate(socks):
            sel.register(c, selectors.EVENT_READ, k)
        fsize = 2 + 2 * ncep            # magic + ncep int16
        while not stop.is_set():
            for key, _ in sel.select(timeout=0.05):
                k = key.data
                try:
                    data = key.fileobj.recv(65536)
                except (BlockingIOError, OSError):
                    continue
                if not data:
                    continue
                before = len(received[k]) // fsize
                received[k] += data
                if len(received[k]) // fsize > before \
                        and last_send[k] is not None:
                    latencies.append(time.perf_counter() - last_send[k])
        sel.close()

    th_s = threading.Thread(target=sender, daemon=True)
    th_r = threading.Thread(target=reader, daemon=True)
    t0 = time.perf_counter()
    th_s.start()
    th_r.start()
    time.sleep(seconds)
    stop.set()
    th_s.join(timeout=2)
    th_r.join(timeout=2)
    elapsed = time.perf_counter() - t0
    in_window = [len(r) for r in received]
    _close(socks, received, backlog)
    return dict(sent=sent, received=[bytes(r) for r in received],
                in_window=in_window, elapsed=elapsed, latencies=latencies,
                missed=missed[0], period=period, connect_s=connect_s)


def _close(socks, received, backlog, timeout: float = 30.0) -> None:
    """End every client cleanly: drop its unsent backlog, shut its write
    side (the server flushes the partial chunk and closes), read the rest
    until the server's EOF or ``timeout``, then close.  A socket closed
    with replies unread would reset the connection instead."""
    open_ = {}
    sel = selectors.DefaultSelector()
    for k, c in enumerate(socks):
        backlog[k] = b""
        try:
            c.shutdown(socket.SHUT_WR)
        except OSError:
            c.close()
            continue
        sel.register(c, selectors.EVENT_READ, k)
        open_[k] = c
    deadline = time.perf_counter() + timeout
    while open_ and time.perf_counter() < deadline:
        for key, _ in sel.select(timeout=0.05):
            k = key.data
            try:
                data = key.fileobj.recv(65536)
            except BlockingIOError:
                continue
            except OSError:
                data = b""
            if data:
                received[k] += data
            else:
                sel.unregister(key.fileobj)
                key.fileobj.close()
                del open_[k]
    for c in open_.values():
        c.close()
    sel.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--ncep", type=int, default=16)
    ap.add_argument("--float", action="store_true")
    ap.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                    help="where the server step runs: 'cuda' (default) is "
                         "the card; 'cpu' the host")
    ap.add_argument("--tick", type=float, default=0.002)
    ap.add_argument("--trace-out", metavar="DIR",
                    help="record the server's spans and a torch.profiler "
                         "trace; write both to DIR on one clock and print "
                         "the card's longest idle gaps with the server "
                         "spans that cover them")
    args = ap.parse_args(argv)

    from mfcc_tpu_torch.config import MFCCConfig
    from mfcc_tpu_torch import server as srv
    from mfcc_tpu_torch.cli import backend_device

    cfg = MFCCConfig(nceptrums=args.ncep)
    device = backend_device(args.backend, "server_loadtest")
    N, C = args.streams, args.chunk
    print(f"# starting server: {N} slots, chunk={C}, "
          f"{'float' if args.float else 'int'} path, "
          f"device={args.backend} ... (the first start builds the kernels)",
          flush=True)
    trace = args.trace_out is not None
    with (_profiler(device) if trace else contextlib.nullcontext()) as prof:
        s = srv.FeatureServer(cfg, max_streams=N, chunk=C,
                              int_path=not args.float, tick_s=args.tick,
                              device=device,
                              trace_capacity=TRACE_CAPACITY if trace else 0
                              ).start()
        try:
            host, port = s.address
            # occupancy over the load and the clients' close that drains
            # it, over the same stretch of wall time
            st0, t0 = s.stats(), time.perf_counter()
            t_load = time.time_ns()
            run = run_clients(host, port, N, C, args.seconds, cfg.nceptrums,
                              cfg.samplerate)
            t_end = time.time_ns()
            st = {k: v - st0[k] for k, v in s.stats().items()}
            stats_s = time.perf_counter() - t0
        finally:
            s.stop()
    summary = summarize(run, N, cfg.nceptrums, cfg.samplerate, cfg.hop)
    print(f"streams={N} chunk={C} path={'float' if args.float else 'int'} "
          f"device={args.backend}")
    print_summary(summary, st, stats_s)
    if trace:
        write_trace(args.trace_out, prof, s, t_load, t_end)
    return 0


def _profiler(device):
    """``torch.profiler`` over the host ops of every thread (by default it
    records only the thread that starts it) and the card's activity."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig
        config = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):      # a torch without the option
        return profile(activities=acts)
    return profile(activities=acts, experimental_config=config)


def write_trace(out_dir: str, prof, server, t0_ns: int, t1_ns: int,
                top: int = 10) -> None:
    """Write ``timeline.json`` (the profiler's Chrome trace with the
    server's spans on its clock) and ``server.json`` (the spans alone) to
    ``out_dir``; print the card's idle share over the load [t0_ns, t1_ns]
    (epoch ns) and its ``top`` longest idle gaps, each with the share of
    it that each server thread's phases cover."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "timeline.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        timeline = json.load(f)
    base = int(timeline.get("baseTimeNanoseconds", 0))
    spans = server.trace_events(base)
    with open(os.path.join(out_dir, "server.json"), "w") as f:
        json.dump({"traceEvents": spans, "baseTimeNanoseconds": base}, f)
    timeline["traceEvents"] += spans
    with open(path, "w") as f:
        json.dump(timeline, f)
    device = [(e["ts"], e["ts"] + e["dur"]) for e in timeline["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    lo, hi = (t0_ns - base) / 1e3, (t1_ns - base) / 1e3
    print(f"trace: {len(spans)} server events and the profiler's in "
          f"{path}")
    if not device:
        print("device: no device activity recorded")
        return
    idle, gaps = idle_gaps(device, spans, lo, hi, top)
    print(f"device: idle {idle * 100:.2f}% of the load "
          f"({(hi - lo) / 1e6:.3f} s); longest idle gaps, each with the "
          f"share of it that each server thread's phases cover:")
    for start, dur, cover in gaps:
        where = "; ".join(
            f"{t} " + ", ".join(f"{name} {share * 100:.0f}%"
                                for name, share in phases[:3])
            for t, phases in cover.items()) or "no server span"
        print(f"  {dur / 1e3:.3f} ms at +{(start - lo) / 1e6:.4f} s: {where}")


def idle_gaps(device: list, spans: list, lo: float, hi: float,
              top: int = 10) -> tuple:
    """The card's idle share of [lo, hi] and its ``top`` longest idle
    gaps there, from ``device`` ((start, end) of each device activity) and
    the server's ``spans`` (``trace_events``), all in µs on one clock.  A
    gap is (start, length, {thread: [(phase, share of the gap its spans
    cover), ...] most first}), each server thread's phases named by its
    innermost spans (a dispatch by its parts); what no span covers is the
    thread between phases, or waiting for the interpreter lock at their
    edges."""
    busy = []
    for a, b in sorted(device):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = sorted(((edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])
    idle = sum(b - a for a, b in gaps) / (hi - lo)
    names = {e["tid"]: e["args"]["name"] for e in spans if e["ph"] == "M"}
    xs = [e for e in spans if e["ph"] == "X"]
    parents = {e["args"]["parent"] for e in xs if "parent" in e["args"]}
    threads = {}
    for t in SERVER_THREADS:
        mine = [e for e in xs if names.get(e["tid"]) == f"FeatureServer {t}"
                and e["args"]["id"] not in parents]
        if mine:
            ts = np.array([e["ts"] for e in mine])
            phase, which = np.unique([e["name"] for e in mine],
                                     return_inverse=True)
            threads[t] = (phase, which, ts,
                          ts + np.array([e["dur"] for e in mine]))
    out = []
    for a, b in gaps[:top]:
        cover = {}
        for t, (phase, which, ts, te) in threads.items():
            ov = np.clip(np.minimum(te, b) - np.maximum(ts, a), 0, None)
            by = np.bincount(which, weights=ov, minlength=len(phase))
            order = [k for k in np.argsort(-by, kind="stable") if by[k] > 0]
            if order:
                cover[t] = [(str(phase[k]), float(by[k] / (b - a)))
                            for k in order]
        out.append((a, b - a, cover))
    return idle, out


def summarize(run: dict, n_streams: int, ncep: int,
              samplerate: int = 16000, hop: int = 170) -> dict:
    """The load's numbers: sustained frames/s, the share of the offered
    real-time load, latency percentiles (ms), missed periods."""
    fsize = 2 + 2 * ncep                # magic + ncep int16
    frames = sum(n // fsize for n in run["in_window"])
    fps = frames / run["elapsed"]
    per_stream_rt = samplerate / hop    # ~94.1 frames/s
    lat = (np.sort(np.array(run["latencies"])) if run["latencies"]
           else np.array([0.0]))
    return dict(frames=frames, fps=fps,
                rt_share=fps / (n_streams * per_stream_rt),
                rt_streams=fps / per_stream_rt,
                p50_ms=float(np.percentile(lat, 50)) * 1e3,
                p99_ms=float(np.percentile(lat, 99)) * 1e3,
                missed=run["missed"], period_ms=run["period"] * 1e3)


def print_summary(summary: dict, st: dict, elapsed: float) -> None:
    """The JAX example's summary lines, and the occupancy of the server's
    threads; ``st`` is the change of the server's stats over ``elapsed``
    wall seconds."""
    def pct(key):
        return f"{st[key] / elapsed * 100:.1f}%"

    print(f"sustained: {summary['fps']:,.0f} frames/s "
          f"({summary['rt_share'] * 100:.1f}% of the offered "
          f"real-time load; sender missed {summary['missed']} periods)")
    print(f"latency: p50={summary['p50_ms']:.1f} ms "
          f"p99={summary['p99_ms']:.1f} ms (chunk period "
          f"{summary['period_ms']:.0f} ms)")
    print(f"stepper: {st['steps']} steps, gather {pct('gather_s')} + "
          f"dispatch {pct('compute_s')} + backpressure "
          f"{pct('backpressure_s')} + wait {pct('wait_s')}, "
          f"{st['idle_ticks']} idle ticks")
    print(f"delivery: deliver {pct('deliver_s')} (readback wait "
          f"{pct('readback_wait_s')} + encode {pct('encode_s')} + send "
          f"{pct('send_s')}), a step "
          f"{st['outq_wait_s'] / max(st['steps'], 1) * 1e3:.2f} ms in the "
          f"queue")
    print(f"reader: {st['recvs']} recvs, {pct('reader_s')} outside select; "
          f"cpu: stepper {pct('stepper_cpu_s')}, delivery "
          f"{pct('delivery_cpu_s')}, reader {pct('reader_cpu_s')} of a core")


if __name__ == "__main__":
    raise SystemExit(main())
