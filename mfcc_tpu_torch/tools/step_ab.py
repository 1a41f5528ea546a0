"""Time the batch kernels K1, K2, K9, K3, K3-v1, K10's epilogue, K7, K5 and
K8 and the serving steps of several checkouts of the port on one CUDA card,
one process per checkout, in the order given.

    python3 mfcc_tpu_torch/tools/step_ab.py [--int | --serve] TREE [TREE ...]

Each TREE is a directory that holds a ``mfcc_tpu_torch`` package (a
checkout, or ``git archive`` of one); give two trees in the order A B B A
so that drift between processes shows.  Each process builds that tree's
kernels and prints one JSON line with the tree, the card
(``nvidia-smi``), and, as ``chip_smoke.py`` times them: K1
(``fladder.mfcc_float_ladder``) and K2 (``int_fused.mfcc_int_fused``) at
S=1024 streams x T=63,922 int16 samples (4 s, 382,976 frames), with K1's
max-abs difference from its plain version; K9 (``mfcc_int_v2``, K2's
kernel) on them, K3 (``mfcc_int_fused_frames``) on their (1024, 374, 512)
int32 emphasized frames and K10's epilogue (``mfcc_int_epi``) on their
(1024, 374, 256) power rows (``mfcc_int_front``), each element-exact with
K2's function, so their digests (``k2_sha1``, ``k9_sha1``, ``k3_sha1``,
``k10_epi_sha1``) are one in every tree (``int_same_ok``); K3-v1
(``int_fused.mfcc_int_v1``) on the same samples as int32, K7
(``f64ish.mfcc_f64ish``) on them and K7-frames (``mfcc_f64ish_frames``)
on their (1024, 374, 512) f32 frames, and K1 and K7 at the JAX bench's
f64ish shape S=512 x T=16,322 (``*_bench_ms``), with a digest of each
output of K1, K2, K9, K3, K10's epilogue, K3-v1, K7 and K7-frames held to
the first tree's bit for bit (``*_ok``: these kernels' arithmetic is
fixed, so a tree that moves a bit has changed it); K8
(``dense_fused.mfcc_raw`` and ``mfcc_batch_dense``) and K5
(``float_fused.mfcc_radix2`` at 3 and 6 passes) on the same input, with a
digest of each output and its max-abs difference from the first tree's
(``*_vs_first``; K8 within 5e-5 and K5 within 2e-4 pass, ``*_ok``: a
product summed in another order may move the last bits, so the digests
may differ while the function holds); and at S=4096 streams x C=1024-sample
int16 chunks the K4-float, K4-split (3 passes) and K4-INT kernels
(``stream_fused.stream_step_{float,int}``) and ``StreamingMFCC().step``,
float and INT (the mean of a chain of 16 steps with the state threaded
through); each the median of 10 after warm-up, device time by CUDA
events.  ``*_host_ms`` is the host's time to issue one step of the chain
(no synchronization inside it): a step whose host time reaches its device
time is held back by the host.  A single call's CUDA-event time also holds
the host's issue time between the first event and the launch; the K4
kernels are also timed as the mean of 16 calls back to back behind a call
already queued (``*_b2b_ms``), where the card waits for the host only if
the host issues slower than the kernel runs.  In a tree with the
step-level entries (``stream_step_{float,int}_state``, the whole
full-chunk step in one launch) it also times those (``k4_*_state_ms``,
with their host issue time, and ``k4_*_state_b2b_ms``) and breaks one
step's host time down (``host_*_us``: the step, the entry, its checks, its
five allocations, a ``torch.cuda.device`` context, ``current_stream``, the
ctypes call without and with the launch; only in trees whose C entry
takes this script's argument list).  With ``--int`` each process times the INT batch
kernels alone (K2, K9, K3, K10's epilogue, K3-v1), a quicker
A/B of INT variants; with ``--serve`` the serving steps alone.  The
first tree's outputs are kept in
``mfcc_tpu_torch/_build/step_ab/`` of the tree that runs the script, for
the later trees to compare with.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

S, C, STEPS, ITERS, WARMUP = 4096, 1024, 16, 10, 3
S_BATCH, T_BATCH = 1024, 63_922
S_BENCH, T_BENCH = 512, 512 + 93 * 170     # the JAX bench's f64ish shape
KERNEL_TOL, R2_TOL = 5e-5, 2e-4     # chip_smoke.py's
REF_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "step_ab")


def make_audio(S: int, T: int, seed: int):
    """``chip_smoke.make_audio``: a chirp and a tone shared by all streams
    plus per-stream uniform noise, integer-valued."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000.0
    base = (9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
            + 4000 * np.sin(2 * np.pi * 900 * t))
    noise = rng.integers(-1500, 1500, (S, T))
    return np.round(np.clip(base[None, :] + noise,
                            -32768, 32767)).astype(np.float32)


def time_ms(fn) -> tuple[float, float]:
    """(median device ms, median host ms) of one call."""
    import torch
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(ITERS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b))
    return statistics.median(dev), statistics.median(host)


def against_first(out: dict, name: str, got, first: bool, tol: float
                  ) -> None:
    """A digest of ``got`` and its max-abs difference from the first
    tree's output of the same name (saved by the first tree)."""
    import numpy as np
    a = got.cpu().numpy()
    out[f"{name}_sha1"] = hashlib.sha1(a.tobytes()).hexdigest()
    path = os.path.join(REF_DIR, name + ".npy")
    if first:
        os.makedirs(REF_DIR, exist_ok=True)
        np.save(path, a)
    ref = np.load(path)
    fin = np.isfinite(ref)
    ok = bool((np.isfinite(a) == fin).all())
    e = float(np.abs(a[fin] - ref[fin]).max()) if fin.any() else 0.0
    out[f"{name}_vs_first"] = e
    out[f"{name}_ok"] = ok and e <= tol


INT_KEYS = ("k2", "k9", "k3", "k10_epi", "k3v1")


def child(tree: str, first: bool, mode: str = "all") -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from mfcc_tpu_torch import MFCCConfig
    from mfcc_tpu_torch.kernels import build
    from mfcc_tpu_torch.ops import (dense_fused, f64ish, fladder,
                                    float_fused, framing, int_fused)

    build.build()
    build.library()
    dev = torch.device("cuda", 0)
    cfg = MFCCConfig()
    out = {"tree": tree}
    if mode == "serve":
        return serving(out, dev, cfg)
    int_only = mode == "int"
    audio = torch.from_numpy(make_audio(S_BATCH, T_BATCH, seed=0)
                             .astype(np.int16)).to(dev)
    if not int_only:
        out["k1_vs_plain"] = float((fladder.mfcc_float_ladder(audio, cfg)
                                    - fladder.mfcc_float_ladder_plain(
                                        audio, cfg)).abs().max())
    audio32 = audio.to(torch.int32)
    iframes = framing.extract_frames(framing.preemphasis_int(audio32),
                                     cfg.nfft, cfg.hop).contiguous()
    power = int_fused.mfcc_int_front(audio, cfg)
    hframes = framing.extract_frames(framing.preemphasis(
        audio.to(torch.float32)), cfg.nfft, cfg.hop).contiguous()
    bench = torch.from_numpy(make_audio(S_BENCH, T_BENCH, seed=3)
                             .astype(np.int16)).to(dev)
    for name, fn in (
            ("k1", lambda: fladder.mfcc_float_ladder(audio, cfg)),
            ("k2", lambda: int_fused.mfcc_int_fused(audio, cfg)),
            ("k9", lambda: int_fused.mfcc_int_v2(audio, cfg)),
            ("k3", lambda: int_fused.mfcc_int_fused_frames(iframes, cfg)),
            ("k10_epi", lambda: int_fused.mfcc_int_epi(power, cfg)),
            ("k3v1", lambda: int_fused.mfcc_int_v1(audio32, cfg)),
            ("k7", lambda: f64ish.mfcc_f64ish(audio, cfg)),
            ("k7_frames", lambda: f64ish.mfcc_f64ish_frames(hframes, cfg))):
        if int_only and name not in INT_KEYS:
            continue
        against_first(out, name, fn(), first, 0.0)
        out[f"{name}_ms"] = time_ms(fn)[0]
    out["int_same_ok"] = len({out[f"{k}_sha1"] for k in (
        "k2", "k9", "k3", "k10_epi")}) == 1
    if int_only:
        return out
    for name, fn in (
            ("k1_bench", lambda: fladder.mfcc_float_ladder(bench, cfg)),
            ("k7_bench", lambda: f64ish.mfcc_f64ish(bench, cfg))):
        out[f"{name}_ms"] = time_ms(fn)[0]
    del audio32, hframes, bench, iframes, power
    for name, fn, tol in (
            ("k8_raw", lambda: dense_fused.mfcc_raw(audio, cfg), KERNEL_TOL),
            ("k8_batch", lambda: dense_fused.mfcc_batch_dense(audio, cfg),
             KERNEL_TOL),
            ("k5_3", lambda: float_fused.mfcc_radix2(audio, cfg,
                                                     dft_passes=3), R2_TOL),
            ("k5_6", lambda: float_fused.mfcc_radix2(audio, cfg,
                                                     dft_passes=6), R2_TOL)):
        against_first(out, name, fn(), first, tol)
        out[f"{name}_ms"] = time_ms(fn)[0]
    del audio
    return serving(out, dev, cfg)


def time_b2b(fn, n: int = 16) -> float:
    """Device ms of one call: ``n`` calls back to back between two CUDA
    events, the first recorded behind one more call so that the card is
    busy while the timed calls are issued; the median over ITERS."""
    import torch
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ITERS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        fn()
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def serving(out: dict, dev, cfg) -> dict:
    """The K4 kernels and ``StreamingMFCC.step`` at S x C (see the notes
    above), into ``out``."""
    import numpy as np
    import torch
    from mfcc_tpu_torch import StreamingMFCC
    from mfcc_tpu_torch.ops import stream_fused
    serve = torch.from_numpy(make_audio(S, (STEPS + 2) * C, seed=6)
                             .astype(np.int16)).to(dev)
    chunks = [serve[:, i * C:(i + 1) * C].contiguous()
              for i in range(STEPS + 2)]
    for int_path in (False, True):
        kind = "int" if int_path else "float"
        sm = StreamingMFCC(int_path=int_path)
        state = sm.init(S)
        for c in chunks[:2]:                    # a carry of real audio
            _, _, state = sm.step(c, state)
        start = (cfg.windowlen - 1 - state.count).to(torch.int32)
        args = (state.buffer, chunks[2], start, state.prev, cfg)
        kern = (stream_fused.stream_step_int if int_path
                else stream_fused.stream_step_float)
        out[f"k4_{kind}_ms"] = time_ms(lambda: kern(*args))[0]
        out[f"k4_{kind}_b2b_ms"] = time_b2b(lambda: kern(*args))
        if not int_path:
            out["k4_split_ms"] = time_ms(lambda: kern(*args,
                                                      dft_passes=3))[0]
        state_entry = getattr(stream_fused, f"stream_step_{kind}_state",
                              None)
        if state_entry is not None:         # trees with the step-level entry
            sargs = (state.buffer, chunks[2], state.count, state.prev, None,
                     cfg)
            out[f"k4_{kind}_state_ms"], out[f"k4_{kind}_state_host_ms"] = \
                time_ms(lambda: state_entry(*sargs))
            out[f"k4_{kind}_state_b2b_ms"] = time_b2b(
                lambda: state_entry(*sargs))
            out.update(host_breakdown(kind, sm, state, chunks[2], sargs))

        def chain():
            st = state
            for c in chunks[2:]:
                _, _, st = sm.step(c, st)
        d, h = time_ms(chain)
        out[f"step_{kind}_ms"] = d / STEPS
        out[f"step_{kind}_host_ms"] = h / STEPS
    return out


def host_us(fn, n: int = 20, reps: int = 30) -> float:
    """Median host microseconds of one call of ``fn``: ``n`` calls back to
    back, the card synchronized between the ``reps`` batches (so that no
    launch waits for room in the launch queue)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / n)
    torch.cuda.synchronize()
    return statistics.median(times)


def host_breakdown(kind: str, sm, state, chunk, sargs) -> dict:
    """Where the host time of one full-chunk ``StreamingMFCC.step`` goes
    (``host_{kind}_*_us``, each the median of ``host_us``): the whole step
    and the step-level entry it calls; inside the entry the operand checks
    (``stream_fused._check_step``), the five output allocations, entering
    and leaving ``torch.cuda.device`` (which ``build.launch`` skips when
    the device is current), ``torch.cuda.current_stream``, the ctypes call
    with S = 0 (argument conversion and the C entry's checks, no launch),
    and the ctypes call that launches (the kernel's own launch on top)."""
    import torch
    from mfcc_tpu_torch.kernels import build
    from mfcc_tpu_torch.ops import fladder, int_fused
    from mfcc_tpu_torch.ops import stream_fused as sf
    cfg = sargs[-1]
    buf, x, count, prev = sargs[:4]
    dev = x.device
    S, C = x.shape
    P = cfg.windowlen - 1
    F = sf.frames_per_step(C, cfg)
    int_path = kind == "int"
    entry = (sf.stream_step_int_state if int_path
             else sf.stream_step_float_state)
    sdt = torch.int32 if int_path else torch.float32
    chunk_dtypes = ((torch.int16, torch.int32) if int_path
                    else (torch.int16, torch.float32))
    outs = [torch.empty((S, F, cfg.nceptrums), dtype=sdt, device=dev),
            torch.empty((S, F), dtype=torch.bool, device=dev),
            torch.empty((S, P), dtype=sdt, device=dev),
            torch.empty((S,), dtype=torch.int32, device=dev),
            torch.empty((S,), dtype=sdt, device=dev)]
    lib = build.library()
    if int_path:
        fn = lib.mfcc_stream_int_i16
        ops = int_fused.int_operators(cfg, dev)
        mid = ()
        rest = (*int_fused.tail_args(cfg, ops), ops.curve.data_ptr(),
                ops.tw.data_ptr(), ops.dtw.data_ptr(), ops.fbs.data_ptr())
    else:
        fn = lib.mfcc_stream_f32_i16
        ops = fladder.default_operators(cfg, dev)
        mid = (cfg.nfft, cfg.nfilters, cfg.nceptrums)
        rest = (*fladder.tail_tables(ops, cfg, dev), 0.0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def c_args(n):
        return (buf.data_ptr(), x.data_ptr(), count.data_ptr(), 0,
                prev.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
                outs[2].data_ptr(), outs[3].data_ptr(), outs[4].data_ptr(),
                n, P, C, F, cfg.hop, *mid,
                *sf._strides(buf, x, outs[2], False, "time"), *rest, stream)

    if len(fn.argtypes) != len(c_args(0)):    # another tree's C entry
        return {}

    def ctx():
        with torch.cuda.device(dev):
            pass

    def alloc():
        torch.empty((S, F, cfg.nceptrums), dtype=sdt, device=dev)
        torch.empty((S, F), dtype=torch.bool, device=dev)
        torch.empty((S, P), dtype=sdt, device=dev)
        torch.empty((S,), dtype=torch.int32, device=dev)
        torch.empty((S,), dtype=sdt, device=dev)

    empty_args, launch_args = c_args(0), c_args(S)
    k = f"host_{kind}"
    return {
        f"{k}_step_us": host_us(lambda: sm.step(chunk, state)),
        f"{k}_entry_us": host_us(lambda: entry(*sargs)),
        f"{k}_checks_us": host_us(lambda: sf._check_step(
            buf, x, count, prev, cfg, False, "time", sdt, chunk_dtypes,
            "K4", None, "count")),
        f"{k}_alloc5_us": host_us(alloc),
        f"{k}_device_ctx_us": host_us(ctx),
        f"{k}_current_stream_us": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        f"{k}_ctypes_s0_us": host_us(lambda: fn(*empty_args)),
        f"{k}_ctypes_launch_us": host_us(lambda: fn(*launch_args)),
    }


def main(argv: list[str]) -> int:
    if len(argv) >= 4 and argv[0] == "--child":
        print(json.dumps(child(argv[1], argv[2] == "first", argv[3])),
              flush=True)
        return 0
    mode = {"--int": "int", "--serve": "serve"}.get(argv[0] if argv else "",
                                                   "all")
    argv = argv[mode != "all":]
    if not argv:
        raise SystemExit(__doc__)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    rc = 0
    for i, tree in enumerate(map(os.path.abspath, argv)):
        res = subprocess.run([sys.executable, __file__, "--child", tree,
                              "first" if i == 0 else "later", mode],
                             capture_output=True, text=True, timeout=600)
        line = res.stdout.strip().splitlines()[-1] if res.stdout.strip() \
            else ""
        if res.returncode != 0 or not line.startswith("{"):
            sys.stderr.write(res.stderr[-4000:])
            print(json.dumps({"tree": tree, "rc": res.returncode}))
            rc = 1
            continue
        row = json.loads(line)
        row["card"] = card
        print(json.dumps(row), flush=True)
        if not all(v for k, v in row.items() if k.endswith("_ok")):
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
