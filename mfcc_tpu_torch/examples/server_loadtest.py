"""Loopback load test: N synthetic REAL-TIME clients against FeatureServer.

The counterpart of the JAX package's ``examples/server_loadtest.py``.
Measures the server AS a server: sustained frames/s, per-chunk reply
latency (p50/p99), and stepper-loop occupancy (time in the per-slot Python
gather vs the batched device step), with every client pacing chunk-sized
sends at the real-time rate (C/16000 s period).

    python -m mfcc_tpu_torch.examples.server_loadtest --streams 256 --seconds 8
    python -m mfcc_tpu_torch.examples.server_loadtest --streams 64 --backend cpu

One sender thread paces all sockets; one selector-driven reader drains
replies, so the harness itself scales to hundreds of connections.  The
client side is ``run_clients``, which any server address can be driven
with; it returns what each client sent and received.
"""

import argparse
import selectors
import socket
import threading
import time

import numpy as np


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
    s = srv.FeatureServer(cfg, max_streams=N, chunk=C,
                          int_path=not args.float, tick_s=args.tick,
                          device=device).start()
    try:
        host, port = s.address
        st0 = s.stats()                 # snapshot: occupancy over the load
        run = run_clients(host, port, N, C, args.seconds, cfg.nceptrums,
                          cfg.samplerate)
        st = {k: v - st0[k] for k, v in s.stats().items()}
    finally:
        s.stop()
    summary = summarize(run, N, cfg.nceptrums, cfg.samplerate, cfg.hop)
    print(f"streams={N} chunk={C} path={'float' if args.float else 'int'} "
          f"device={args.backend}")
    print_summary(summary, st, run["elapsed"])
    return 0


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
    """The JAX example's summary lines; ``st`` is the server's stats over
    the load window."""
    busy = st["gather_s"] + st["compute_s"] + st["deliver_s"]
    print(f"sustained: {summary['fps']:,.0f} frames/s "
          f"({summary['rt_share'] * 100:.1f}% of the offered "
          f"real-time load; sender missed {summary['missed']} periods)")
    print(f"latency: p50={summary['p50_ms']:.1f} ms "
          f"p99={summary['p99_ms']:.1f} ms (chunk period "
          f"{summary['period_ms']:.0f} ms)")
    print(f"stepper: {st['steps']} steps, occupancy "
          f"{busy/elapsed*100:.1f}% (gather {st['gather_s']/elapsed*100:.1f}%"
          f" + dispatch {st['compute_s']/elapsed*100:.1f}%"
          f" + deliver {st['deliver_s']/elapsed*100:.1f}%), "
          f"{st['idle_ticks']} idle ticks")


if __name__ == "__main__":
    raise SystemExit(main())
