"""The live-feature server under open-loop load: ``FeatureServer`` in this
process, its N loopback clients (``clients.py``) in a process of their own,
started first, its imports and inputs done while the server starts.

Traffic parameters: ``clients``, ``chunk``, ``ring_chunks`` (each client
sends its own seeded ring of chunks over and over), ``sample_clients``
(clients drawn from the seed whose replies are judged whole), ``lead_s``
(from the clients' connection to the first due time), ``warm_s`` (the load
that runs before the window, as set-up: the server reaches its steady
state, and the window's chunks and latencies are those due after it),
``grace_s`` (how long after the window unanswered chunks are waited for),
``trace_seconds``.
``correct`` needs every chunk due in the window answered, and every frame
that the sampled clients received, all of them, equal to the reference run
on the samples each sent."""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .. import inputs
from ..harness import ROOT, Check, Outcome
from ..ref import torch_ref
from ..trace import Profile
from ._window import memory_peak
from .clients import chunk_frames, decode, raise_nofile


def _line(proc, word: str) -> list:
    line = proc.stdout.readline().decode().split()
    if not line or line[0] != word:
        raise RuntimeError(f"load generator: expected {word!r}, got {line}")
    return line[1:]


def run(ctx) -> Outcome:
    from mfcc_tpu_torch import FeatureServer

    p, conf, dev = ctx.traffic, ctx.config, ctx.device
    if conf["path"] != "int":
        raise ValueError("the serve driver judges the INT wire only; the "
                         "float wire (rounded, mel floor 1) needs its own")
    cfg = ctx.program_config()
    N, C = p["clients"], p["chunk"]
    raise_nofile()
    sample = sample_clients(ctx.seed, N, p["sample_clients"])
    params = {"clients": N, "chunk": C, "ring_chunks": p["ring_chunks"],
              "seconds": ctx.seconds, "seed": ctx.seed, "sample": sample,
              "samplerate": cfg.samplerate, "windowlen": cfg.windowlen,
              "hop": cfg.hop, "ncep": cfg.nceptrums, "lead_s": p["lead_s"],
              "warm_s": p["warm_s"], "grace_s": p["grace_s"]}
    proc = subprocess.Popen(
        [sys.executable, "-m", "perfbench.drivers.clients"], cwd=ROOT,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    server, prof = None, None
    try:
        if ctx.trace:
            # recording from before the server's threads exist: the card's
            # activity from every thread, the stretch marked at the end
            prof = Profile()
            prof.start()
        proc.stdin.write((json.dumps(params) + "\n").encode())
        proc.stdin.flush()
        server = FeatureServer(cfg, max_streams=N, chunk=C,
                               int_path=True, device=dev).start()
        ctx.mark("server started")
        _line(proc, "ready")
        ctx.mark("load generator")
        host, port = server.address
        proc.stdin.write(f"go {host} {port}\n".encode())
        proc.stdin.flush()
        t0 = float(_line(proc, "start")[0])
        _sleep_until(t0)                    # the load's warm-up runs
        st0 = server.stats()
        st_mid, t_mid = None, None
        if ctx.trace:
            # the traced stretch ends the window; the server's shares are
            # read over the window before it
            _sleep_until(t0 + ctx.seconds - p["trace_seconds"])
            st_mid, t_mid = server.stats(), time.perf_counter()
            prof.begin()
            _sleep_until(t0 + ctx.seconds)
            prof.end()
        _sleep_until(t0 + ctx.seconds)
        st1 = server.stats()
        t1 = float(_line(proc, "end")[0])
        peak = memory_peak(dev)
        summary = None
        if prof is not None:
            prof.stop()
            summary = prof.result()
        n = int(_line(proc, "blob")[0])
        res = dict(np.load(io.BytesIO(proc.stdout.read(n))))
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if server is not None:
            server.stop()
    del server
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    window = t1 - t0
    due_t = (t0 - p["warm_s"] + res["phase"][:, None]
             + np.arange(res["lat"].shape[1])[None, :] * C / cfg.samplerate)
    due = (due_t >= t0) & (due_t < t1)          # the window's chunks
    lat = res["lat"][due]
    unanswered = int(np.isnan(lat).sum())
    # an unanswered chunk waited at least until the generator gave up
    lat = np.where(np.isnan(lat), t1 + p["grace_s"] - due_t[due], lat)
    st_end, t_end = (st_mid, t_mid) if ctx.trace else (st1, t1)
    stats = {k: st_end[k] - st0[k] for k in st0}
    rate = cfg.samplerate / cfg.hop
    late = res["late"]
    extra = {"load": {
        "clients": N, "chunks_due": int(due.sum()),
        "sender_late_p50_ms": float(np.percentile(late, 50) * 1e3),
        "sender_late_p99_ms": float(np.percentile(late, 99) * 1e3),
        "sender_late_max_ms": float(late.max() * 1e3),
        "connect_s": float(res["t"][2]),
        # the replies' latency from each chunk's due time: a tail too
        # unsteady from run to run for a bound (PERF.md), reported here
        **{f"reply_p{q}_ms": float(np.percentile(lat, q) * 1e3)
           for q in (50, 95, 99)},
        "p50_ms_by_quarter": _by_quarter(lat, due_t[due] - t0, ctx.seconds)}}
    layer = {"server_stats": stats, "window_s": t_end - t0, "profile": summary}

    def check():
        return compare(ctx, res, unanswered)

    return Outcome(
        e2e={"served_streams": float(
                 (res["rx_window"] // (2 * (cfg.nceptrums + 1))).sum()
                 / window / rate),
             "setup_s": t0 - ctx.t_start},
        layer=layer, attempted=int(due.sum()), failed=unanswered,
        memory_peak_bytes=peak, check=check, profile=summary, extra=extra)


def _by_quarter(lat, due_in_window, seconds) -> list:
    """The median latency (ms) of the chunks due in each quarter of the
    window: a backlog that grows shows as a rise from quarter to quarter."""
    q = np.minimum((due_in_window / seconds * 4).astype(int), 3)
    return [float(np.median(lat[q == i]) * 1e3) if (q == i).any() else None
            for i in range(4)]


def sample_clients(seed: int, n: int, k: int) -> list:
    """The clients whose replies are judged whole, drawn from the seed."""
    rng = np.random.default_rng(inputs.subseed(seed, "sample"))
    return sorted(rng.choice(n, min(n, k), replace=False).tolist())


def _sleep_until(t: float) -> None:
    wait = t - time.perf_counter()
    if wait > 0:
        time.sleep(wait)


def compare(ctx, res, unanswered: int) -> list:
    """The sampled clients' frames against the reference on what each
    sent, every frame; the frames each should have are those its sent
    chunks complete."""
    cfg = ctx.ref_config()
    p = ctx.traffic
    C, R = p["chunk"], p["ring_chunks"]
    off = missing = bad_magic = 0
    starts = np.concatenate([[0], np.cumsum(res["kept_len"])])
    for i, c in enumerate(res["sample"].tolist()):
        sent = int(res["sent_n"][c])
        got, bad = decode(res["kept"][starts[i]: starts[i + 1]].tobytes(),
                          cfg.nceptrums)
        bad_magic += bad
        want_n = int(chunk_frames(sent - 1, C, cfg.windowlen, cfg.hop)) \
            if sent else 0
        missing += abs(want_n - len(got))
        if not want_n:
            continue
        ring = inputs.client_audio(ctx.seed, c, R * C)
        audio = np.tile(ring, -(-sent // R))[: sent * C]
        want = torch_ref.mfcc_int(
            torch.as_tensor(audio[None], device=ctx.device), cfg)[0]
        want = torch.clamp(want, -32768, 32767).cpu().numpy()
        m = min(len(got), want_n)
        off += int((got[:m].astype(np.int64) != want[:m]).sum())
    return [Check("chunks_unanswered", unanswered, 0),
            Check("frames_missing", missing, 0),
            Check("bad_magic", bad_magic, 0),
            Check("elements_off", off, ctx.config["limit"])]
