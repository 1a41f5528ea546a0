"""Drive the torch port's float and INT batch paths, its serving path, its
fast and odd-hop float routes and its f64ish and split precisions on one
CUDA card and check them.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA card (the kernels
target sm_90a, Hopper), nvcc and PyTorch built for CUDA.  It

  1. prints the card (``nvidia-smi``), torch's and CUDA's versions;
  2. builds the CUDA kernels from ``mfcc_tpu_torch/csrc`` and prints the
     seconds taken;
  3. float path: compares K1 (``ops/fladder.py``) with its plain torch
     version on the card at nfft 256/86, 512/170 and 1024/340 on int16,
     f32, normalized [-1, 1] f32 and silent (``mel_floor=1.0``) input, and
     at the headline shape, within ``KERNEL_TOL``; drives ``MFCC()`` on
     S=1024 streams x 4 s of int16 audio, checks that K1 launched once per
     call, the shape, finiteness, and the gate against the float64 oracle
     on 8 spread streams; times K1 against its plain version and the plain
     ``float_ops`` chain;
  4. INT path: compares K2 and K3 (``ops/int_fused.py``) with their plain
     versions element for element (``torch.equal``): K2 on tonal, full-range,
     silent and out-of-int16-range input, T = 512 and 512+169, MIC_CONFIG,
     16 filters, hop 160 and the headline shape; K3 on frames with two
     leading axes and on out-of-range int32 frames; drives ``MFCC().int``
     on the headline input, checks that K2 launched once per call and
     ``int_frames`` launched K3, the shape and dtype, and element-exact
     equality with the oracle ``ref.int_ref.mfcc_int`` on 8 spread streams;
     times K2, ``MFCC.int``, K2's plain version, and K3 and its plain
     version on the headline's 382,976 frames;
  5. serving path: compares the stream-step kernels K4 (``ops/
     stream_fused.py``, float and INT) with their plain versions over
     multi-step runs with a mid-run reset of every other stream (S=130, C
     in {1, 170, 600, 1024, 2048}, hop 170 and 160, int16 / int32 outside
     int16 range / non-integer f32 chunks, every carry and chunk layout,
     and S=4096 x C=1024): INT features and every carry with
     ``torch.equal``, float features within ``KERNEL_TOL``; runs
     ``StreamingMFCC().process`` on S=64 streams at C=1024 (64 full chunks)
     and C=149 (ending in a flush), float and INT, against batch K1 / K2
     (INT element for element, float bit for bit on the frames of
     full-chunk steps, since both run the same tail, and within ``GATE``
     of the float64 oracle on 8 spread streams) with the launch counts (K4
     once per full-chunk step, K1/K2 never, K3 once per INT flush); times
     K4 beside its plain version and one ``StreamingMFCC.step`` (the mean
     over a chain of 16) at S=4096 x C=1024 int16, with real-time streams;
     and serves 8 concurrent TCP clients from an INT and a float
     ``FeatureServer`` on the card, each client's frames held equal to the
     INT oracle, resp. to ``StreamingMFCC(mel_floor=1.0)`` on its signal,
     and the frames sent read back over the status plane;
  6. the fast dial and odd hops: compares K5 and K5-frames (``ops/
     float_fused.py``, 3/4/6 passes, nfft 256/512/1024, S=130 at three
     lengths, and the headline input and frames) and K6 (K1's kernel at
     hops 171, 165, 341, and hop 171 on the headline input) with their plain
     versions, and the split-DFT serving step over the K4 runs (every carry
     equal to the plain version's and to K4-float's); holds the fast gate
     (2e-3) on the JAX bench's gate input for K5, K5-frames and streamed
     fast; drives ``MFCC(precision="fast")(audio)``, its ``frames`` and
     ``MFCC(MFCCConfig(step=171))(audio)`` on the headline input and
     ``StreamingMFCC(precision="fast").process`` on S=64 x 64 chunks with
     their launch counts, reads the spread streams against the oracle
     (fast within ``FAST_LONG_GATE``, K6 within ``GATE``), checks streamed
     fast against batch K5; times K1, K5 at 3 and 6 passes, both modules,
     K5-frames on the headline frames, K6 at hop 171 and the split-DFT step
     at S=4096 x C=1024 beside their plain versions;
  7. f64ish and split: compares K7 and K7-frames (``ops/f64ish.py``) with
     their plain versions at nfft 256/86, 512/170 and 1024/340 on S=130 x
     1 s (int16, f32 on the grid, [-1, 1] f32 with and without the wire
     grid, 2^20-scaled f32 without it, samples whose emphasized values sit
     on the grid's ties; frames, and frames at x*32 = k+0.5) and at the
     headline shape, checks that K7 on int16 is K1 bit for bit; holds
     the f64ish gate (``gate_units`` <= 1.0, finite) on the JAX bench's
     gate input and the 8 spread streams; drives
     ``MFCC(precision="f64ish")(audio)`` and its ``frames`` on the headline
     input and ``StreamingMFCC(precision="f64ish").process`` on S=64 at
     C=1024 and C=149 (a flush) with their launch counts (K7 once per call,
     K1 never; K7-frames once per step) against batch K7; holds
     ``MFCC(precision="split")`` and ``method="segmented"`` to the float
     gate on the gate input; times K7, K7-frames, the module and K1 beside
     the plain versions at the headline shape and at the JAX bench's f64ish
     shape (S=512 x T=16,322);
  8. the last TPU kernels' entries: compares K8's seven dense-DFT entries
     (``ops/dense_fused.py``) with their plain versions at nfft 256/86,
     512/170 and 1024/340 on int16 and non-integer f32 input, on silence
     with ``mel_floor`` (fmaj) and on the headline input (``KERNEL_TOL``);
     holds the f32-operand entries and raw to ``GATE`` on the 8 spread
     streams, every entry to ``GATE`` on the JAX bench's gate input, and
     prints the split entries' spread-stream reading; compares K9
     (``int_fused.mfcc_int_v2``), K3-v1 (``mfcc_int_v1``) and K10
     (``mfcc_int_split2``, two launches) with their plain versions and K2
     element for element (K3-v1 with ``int_ref`` on int32 outside the
     int16 range), and with the oracle on the headline's spread streams;
     times every entry, its plain version, K2, and the float64
     ``torch.matmul`` of the headline's DFT product (K8's library_ms).

Times are CUDA events, median of 10 after warm-up.  Each main path
(``MFCC()(audio)``, ``MFCC().int(audio)``, ``MFCC().int_frames(frames)``,
``StreamingMFCC().process``, ``MFCC(precision="fast")(audio)`` and its
``frames``, ``MFCC(MFCCConfig(step=171))(audio)``,
``StreamingMFCC(precision="fast").process``, ``MFCC(precision="f64ish")``
and its ``frames``, ``StreamingMFCC(precision="f64ish").process``, and
each entry of phase 8 on the headline input) is driven with every launch
count set to 0 just before and read just after.  Any failed check raises, so the exit code is not 0.  Without a CUDA card it
exits with an error before printing anything else.  The line before the
last is a JSON summary of the kernels (with each one's bound: the larger
of its bytes over the memory rate and its operations over the peak rate
for their type); the last line is the JSON result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

KERNEL_TOL = 5e-5   # kernel vs its plain version (both float64 inside)
GATE = 5e-4         # the float contract: max-abs vs the float64 oracle
# K5 (split DFT) vs its plain version: both sum exact limb products in
# float64, the f32 mel/log2/DCT sums differ in order; the JAX kernel's own
# distance from the plain version on the CPU tests
R2_TOL = 2e-4
# the fast mode's gate (bench.FAST_GATE), on the JAX bench's gate input
# (bench.accuracy_of: make_audio(2, 512 + 4*170, seed=7)), where the JAX
# kernel holds it
FAST_GATE = 2e-3
# the fast mode on the headline's 8 spread streams x 4 s: the JAX kernel
# itself reads 1.2e-2 there (tests/test_torch_float_fused.py::
# test_fast_mode_long_input_reads_as_jax); the 3-pass limb split sets it
FAST_LONG_GATE = 2e-2
# the f64ish contract (bench.F64ISH_GATE): |got - oracle| <= max(1e-5,
# 2 ulp(oracle)) elementwise, read in gate units (<= 1.0 passes)
F64ISH_GATE = 1e-5
S_MAIN, T_MAIN = 1024, 63_922   # 4 s per stream at 16 kHz: 374 frames
S_SERVE, C_SERVE = 4096, 1024   # the serving shape: streams x chunk samples
ITERS, WARMUP = 10, 3

# Peak rates of an H100 SXM at its 700 W limit (NVIDIA's data sheet):
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12          # FP64 outside the tensor cores
FP32_FLOPS = 67e12          # FP32 outside the tensor cores
BF16_FLOPS = 989e12         # bf16 tensor cores, dense
FP64_TC_FLOPS = 67e12       # FP64 tensor cores (DMMA), dense
# int32 operations: the issue limit of 4 schedulers x 32 lanes per clock
# per SM, 132 SMs at the 1.98 GHz boost clock (the float32 FMA lane rate,
# half of its 67 TFLOP/s); counting only the 64 INT32 lanes per SM gives
# twice the time
INT32_OPS = 128 * 132 * 1.98e9


def make_audio(S: int, T: int, seed: int = 0) -> np.ndarray:
    """Integer-valued samples as float32: a chirp and a tone shared by all
    streams plus per-stream uniform noise (the JAX package's bench
    signal)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000.0
    base = (9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
            + 4000 * np.sin(2 * np.pi * 900 * t))
    noise = rng.integers(-1500, 1500, (S, T))
    return np.round(np.clip(base[None, :] + noise,
                            -32768, 32767)).astype(np.float32)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def compare(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Max-abs difference over the entries where ``want`` is finite; fails
    unless ``got`` is finite exactly where ``want`` is."""
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs "
          f"{tuple(want.shape)}")
    fin = torch.isfinite(want)
    check(bool((torch.isfinite(got) == fin).all()),
          f"{what}: finite where the plain version is not, or the reverse")
    if not bool(fin.any()):
        return 0.0
    return float((got[fin] - want[fin]).abs().max())


def compare_exact(got: torch.Tensor, want: torch.Tensor, what: str) -> int:
    """Element-exact comparison (the INT contract): fails unless
    ``torch.equal``; returns the max-abs difference (0)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
          f"{want.dtype}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    check(torch.equal(got, want), f"{what}: differs from the plain version "
          f"by up to {err}")
    return err


def time_ms(fn) -> float:
    """Median device time of one call, in ms (CUDA events)."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ITERS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def zero_counts(*modules) -> None:
    """Set every launch count of every kernel module to 0 (``LAUNCHES``, an
    int, or a dict of ints per kernel)."""
    for m in modules:
        if isinstance(m.LAUNCHES, dict):
            for k in m.LAUNCHES:
                m.LAUNCHES[k] = 0
        else:
            m.LAUNCHES = 0


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, b,
                 library_ms=None) -> dict:
    """One kernel's entry of the kernels line; ``b`` is ``bound``'s
    (ms, kind)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1], "library_ms": library_ms}


def bound(nbytes: int, ops: float, rate: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time for moving ``nbytes``
    through HBM or doing ``ops`` at ``rate``, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_flops_per_frame(cfg, band: torch.Tensor) -> int:
    """FP64 operations of K1's function per frame: ingest (emphasis and
    window on sample pairs, 6 per packed point), the packed nfft/2-point
    complex FFT counted as radix-4 passes (40 per radix-4 butterfly: 8
    complex adds, 3 complex multiplies and the third twiddle's product; the
    kernel's radix-2 stages do more) and a radix-2 pass when the stage count
    is odd, the real-spectrum unpack and power (19 per bin), the banded mel
    sums (2 per weight), a log2 per filter and the DCT product (2 per
    weight)."""
    m = cfg.nfft // 2
    log2m = m.bit_length() - 1
    fft = (log2m // 2) * (m // 4) * 40 + (log2m % 2) * (m // 2) * 4
    mel = 2 * int((band[:, 1] - band[:, 0]).sum())
    return (6 * m + fft + 19 * m + mel + cfg.nfilters
            + 2 * cfg.nfilters * cfg.nceptrums)


def ladder_ops(log2n: int, nz_re, nz_im, live_re, live_im) -> int:
    """int32 operations that the RTL's radix-2 DIT ladder on 2^log2n points
    needs (csrc/int_stages.cuh ``fft_rows``).  ``nz_*`` say which inputs,
    in the bit-reversed order they are stored in, can be nonzero;
    ``live_*`` which outputs (natural order) are used.  A butterfly costs
    what its nonzero inputs and live outputs need, at most 21: 3 multiplies
    (twr +- twi are table constants), x1r + x1i, m0 + bias, - m1, - m2, two
    >> 14, and per output an add or subtract, >> 1 and a sign-extend.  A
    zero x1 makes both products 0 (bias >> 14 is 0), and an output whose
    terms are both zero is 0."""
    n = 1 << log2n
    nzr, nzi = list(nz_re), list(nz_im)

    def pairs(s):
        span = 1 << s
        return [(((t >> s) << (s + 1)) + (t & (span - 1)),
                 ((t >> s) << (s + 1)) + (t & (span - 1)) + span)
                for t in range(n // 2)]

    seen = []
    for s in range(log2n):        # forward: which values can be nonzero
        seen.append((nzr[:], nzi[:]))
        for i0, i1 in pairs(s):
            x1 = nzr[i1] or nzi[i1]
            nzr[i0] = nzr[i1] = nzr[i0] or x1
            nzi[i0] = nzi[i1] = nzi[i0] or x1
    ops = 0
    lr, li = list(live_re), list(live_im)
    for s in reversed(range(log2n)):   # backward: what each stage must do
        nzr, nzi = seen[s]
        for i0, i1 in pairs(s):
            need1, need2 = lr[i0] or lr[i1], li[i0] or li[i1]
            x1 = nzr[i1] or nzi[i1]
            if x1 and (need1 or need2):
                ops += 2 + (nzr[i1] and nzi[i1])
                ops += need1 * (1 + 2 * nzi[i1]) + need2 * (1 + 2 * nzr[i1])
            for live, a, neg in ((lr[i0], nzr[i0], False),
                                 (lr[i1], nzr[i0], True),
                                 (li[i0], nzi[i0], False),
                                 (li[i1], nzi[i0], True)):
                if live and (a or x1):
                    ops += 2 + (a and x1) + (neg and not a)
            lr[i0], li[i0] = need1, need2
            lr[i1] = li[i1] = need1 or need2
    return ops


def int_ops_per_frame(cfg, band: torch.Tensor) -> int:
    """int32 operations of the INT MFCC function per frame, after
    pre-emphasis: the window (3 per point: multiply, >> 9, sign-extend),
    the 512-point ladder on a real input whose bins outside every filter's
    band are unused, power (4 per used bin), the banded filterbank (2 per
    weight in 64 bits, 2 per filter to extract the field), log2 (7 to
    normalize and mask, 5 per square-and-compare round) and the
    4*nfilters-point DCT ladder on the scattered log-mel row (odd points
    only, real inputs) of which only the real parts of bins [0, ncep) are
    used."""
    nfft, nf = cfg.nfft, cfg.nfilters
    lg = nfft.bit_length() - 1
    used = [False] * nfft
    for lo, hi in band.tolist():
        used[lo:hi] = [True] * (hi - lo)
    fft = ladder_ops(lg, [True] * nfft, [False] * nfft, used, used)
    n4 = 4 * nf
    lg4 = n4.bit_length() - 1
    odd = [bool(int(f"{i:0{lg4}b}"[::-1], 2) & 1) for i in range(n4)]
    ncep = min(cfg.nceptrums, nf)
    dct = ladder_ops(lg4, odd, [False] * n4,
                     [i < ncep for i in range(n4)], [False] * n4)
    fb = 2 * int((band[:, 1] - band[:, 0]).sum()) + 2 * nf
    log2 = nf * (7 + 5 * (cfg.log_precision - 1))
    return 3 * nfft + fft + 4 * sum(used) + fb + log2 + dct


def float_phases(dev, card: str) -> dict:
    """K1 against its plain version, the float main path, and K1's times;
    returns K1's entry of the kernels line."""
    from mfcc_tpu_torch import MFCC, MFCCConfig
    from mfcc_tpu_torch.ops import fladder, float_ops, int_fused, stream_fused
    from mfcc_tpu_torch.ref import float_ref

    # -- K1 vs plain version -------------------------------------------------
    errs = []
    for nfft, hop in ((256, 86), (512, 170), (1024, 340)):
        cfg = MFCCConfig(nfft=nfft, step=hop)
        sig = make_audio(64, 16000, seed=nfft)
        inputs = [
            ("int16", torch.from_numpy(sig.astype(np.int16)), 0.0),
            ("f32", torch.from_numpy(sig), 0.0),
            ("normalized f32", torch.from_numpy(sig / np.float32(32768)), 0.0),
            ("silent, mel_floor=1", torch.zeros(1, 16000), 1.0),
        ]
        if nfft == 512:
            inputs.append(("int16 headline shape", torch.from_numpy(
                make_audio(S_MAIN, T_MAIN).astype(np.int16)), 0.0))
        for name, x, floor in inputs:
            x = x.to(dev)
            got = fladder.mfcc_float_ladder(x, cfg, floor)
            want = fladder.mfcc_float_ladder_plain(x, cfg, floor)
            torch.cuda.synchronize()
            err = compare(got, want, f"K1 nfft {nfft}/{hop} {name}")
            print(f"K1 vs plain, nfft {nfft}/{hop}, {name} "
                  f"{tuple(x.shape)}: max-abs {err:.3e}")
            check(err <= KERNEL_TOL, f"K1 nfft {nfft} {name}: {err} > "
                  f"{KERNEL_TOL}")
            errs.append(err)
        int_out = fladder.mfcc_float_ladder(inputs[0][1].to(dev), cfg)
        f32_out = fladder.mfcc_float_ladder(inputs[1][1].to(dev), cfg)
        check(torch.equal(int_out, f32_out),
              f"K1 nfft {nfft}: int16 and f32 input of the same integers")

    # -- the float main path ---------------------------------------------------
    cfg = MFCCConfig()
    sig = make_audio(S_MAIN, T_MAIN)
    audio = torch.from_numpy(sig.astype(np.int16)).to(dev)
    fe = MFCC().to(dev)
    calls = 2
    zero_counts(fladder, int_fused, stream_fused)
    outs = [fe(audio) for _ in range(calls)]
    torch.cuda.synchronize()
    launches = fladder.LAUNCHES
    check(launches == calls, f"K1 launches {launches} for {calls} calls")
    out = outs[0]
    n_frames = cfg.n_frames(T_MAIN)
    check(tuple(out.shape) == (S_MAIN, n_frames, cfg.nceptrums),
          f"output shape {tuple(out.shape)}")
    check(out.dtype == torch.float32, f"output dtype {out.dtype}")
    check(bool(torch.isfinite(out).all()), "non-finite cepstra")
    check(torch.equal(outs[0], outs[1]), "two calls differ")
    spread = np.linspace(0, S_MAIN - 1, 8).astype(int)
    want = np.stack([float_ref.mfcc_float(sig[i], cfg) for i in spread])
    gate_err = float(np.abs(out[spread].cpu().numpy() - want).max())
    print(f"MFCC()(audio) {tuple(audio.shape)} int16 -> {tuple(out.shape)}: "
          f"K1 launches {launches} in {calls} calls; max-abs vs float64 "
          f"oracle on 8 spread streams {gate_err:.3e} (gate {GATE})")
    check(gate_err <= GATE, f"gate: {gate_err} > {GATE}")
    del outs, out
    chain = float_ops.mfcc_batch(audio, cfg)
    chain_err = float(np.abs(chain[spread].cpu().numpy() - want).max())
    print(f"plain float_ops chain (f32 DFT matmul): max-abs vs oracle "
          f"{chain_err:.3e}")
    del chain

    # -- K1 times --------------------------------------------------------------
    frames = S_MAIN * n_frames
    times = {
        "K1 kernel (mfcc_float_ladder)":
            time_ms(lambda: fladder.mfcc_float_ladder(audio, cfg)),
        "MFCC()(audio), K1 route": time_ms(lambda: fe(audio)),
        "K1 plain version (float64 torch ops)":
            time_ms(lambda: fladder.mfcc_float_ladder_plain(audio, cfg)),
        "plain float_ops.mfcc_batch chain (f32)":
            time_ms(lambda: float_ops.mfcc_batch(audio, cfg)),
    }
    for name, ms in times.items():
        print(f"time {name}: {ms:.4f} ms, {frames / ms * 1e3:.4e} frames/s "
              f"(S={S_MAIN} x T={T_MAIN} int16, median of {ITERS}; {card})")

    ops = fladder.default_operators(cfg, dev)
    nbytes = (audio.nbytes + frames * cfg.nceptrums * 4
              + sum(t.nbytes for t in ops))
    flops = frames * k1_flops_per_frame(cfg, ops.band.cpu())
    bound_ms, bound_by = bound(nbytes, flops, FP64_FLOPS)
    print(f"K1 bound: {nbytes} bytes, {flops:.4e} FP64 operations -> "
          f"{bound_ms:.4f} ms ({bound_by})")
    return {
        "name": "fladder (K1)", "route": "cuda",
        "source": "mfcc_tpu_torch/csrc/fladder.cu",
        "replaces": "mfcc_tpu/ops/pallas_fladder.py:327",
        "launches": launches, "max_abs_err": max(errs),
        "ms": times["K1 kernel (mfcc_float_ladder)"],
        "plain_ms": times["K1 plain version (float64 torch ops)"],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def int_phases(dev, card: str) -> list[dict]:
    """K2 and K3 against their plain versions, the INT main path, and
    their times; returns their entries of the kernels line."""
    from mfcc_tpu_torch import MFCC, MFCCConfig, MIC_CONFIG
    from mfcc_tpu_torch.ops import fladder, framing, int_fused, stream_fused
    from mfcc_tpu_torch.ref import int_ref

    # -- K2 vs plain version -------------------------------------------------
    rng = np.random.default_rng(2)
    tonal = make_audio(64, 16000, seed=3).astype(np.int16)
    headline = make_audio(S_MAIN, T_MAIN).astype(np.int16)
    k2_inputs = [
        ("tonal int16, S=64 x 1 s", MFCCConfig(), tonal),
        ("full-range int16", MFCCConfig(),
         rng.integers(-32768, 32768, (64, 16000)).astype(np.int16)),
        ("silence", MFCCConfig(), np.zeros((8, 16000), np.int16)),
        ("int32 outside int16 range", MFCCConfig(),
         rng.integers(-2 ** 31, 2 ** 31, (16, 16000)).astype(np.int32)),
        ("T=512", MFCCConfig(), tonal[:, :512]),
        ("T=512+169", MFCCConfig(), tonal[:, :512 + 169]),
        ("MIC_CONFIG", MIC_CONFIG, tonal),
        ("nfilters=16", MFCCConfig(nfilters=16, nceptrums=16), tonal),
        ("hop 160", MFCCConfig(step=160), tonal),
        ("headline shape", MFCCConfig(), headline),
    ]
    errs = {"K2": 0, "K3": 0}
    for name, cfg, x in k2_inputs:
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        got = int_fused.mfcc_int_fused(xt, cfg)
        want = int_fused.mfcc_int_fused_plain(xt, cfg)
        torch.cuda.synchronize()
        err = compare_exact(got, want, f"K2 {name}")
        errs["K2"] = max(errs["K2"], err)
        print(f"K2 vs plain, {name} {tuple(xt.shape)} {xt.dtype} -> "
              f"{tuple(got.shape)}: equal (max-abs {err})")
        del got, want

    # -- K3 vs plain version -------------------------------------------------
    xt = torch.from_numpy(tonal[:6].astype(np.int32)).to(dev)
    frames = framing.extract_frames(framing.preemphasis_int(xt), 512, 170)
    wide = rng.integers(-2 ** 31, 2 ** 31, (4, 9, 512)).astype(np.int32)
    for name, f in (("frames of 6 streams as (2, 3, F, 512)",
                     frames.reshape(2, 3, *frames.shape[1:]).contiguous()),
                    ("int32 frames outside int16 range",
                     torch.from_numpy(wide).to(dev))):
        got = int_fused.mfcc_int_fused_frames(f)
        want = int_fused.mfcc_int_fused_frames_plain(f)
        torch.cuda.synchronize()
        err = compare_exact(got, want, f"K3 {name}")
        errs["K3"] = max(errs["K3"], err)
        print(f"K3 vs plain, {name} {tuple(f.shape)} -> {tuple(got.shape)}: "
              f"equal (max-abs {err})")

    # -- the INT main path -----------------------------------------------------
    cfg = MFCCConfig()
    audio = torch.from_numpy(headline).to(dev)
    fe = MFCC()
    check(fe.window.device.type == "cuda",
          f"MFCC() built its operators on {fe.window.device}")
    n_frames = cfg.n_frames(T_MAIN)
    emph = framing.preemphasis_int(audio.to(torch.int32))
    hframes = framing.extract_frames(emph, 512, cfg.hop).contiguous()
    del emph
    calls = 2
    zero_counts(fladder, int_fused, stream_fused)
    outs = [fe.int(audio) for _ in range(calls)]
    torch.cuda.synchronize()
    k2_launches = int_fused.LAUNCHES["K2"]
    check(k2_launches == calls and fladder.LAUNCHES == 0
          and sum(int_fused.LAUNCHES.values()) == calls,
          f"K2 launches {k2_launches} (K1 {fladder.LAUNCHES}) for {calls} "
          "int() calls")
    zero_counts(fladder, int_fused, stream_fused)
    out_frames = fe.int_frames(hframes)
    torch.cuda.synchronize()
    k3_launches = int_fused.LAUNCHES["K3"]
    check(k3_launches == 1 and fladder.LAUNCHES == 0
          and sum(int_fused.LAUNCHES.values()) == 1,
          f"K3 launches {k3_launches} (K1 {fladder.LAUNCHES}) for one "
          "int_frames() call")
    out = outs[0]
    check(tuple(out.shape) == (S_MAIN, n_frames, cfg.nceptrums),
          f"INT output shape {tuple(out.shape)}")
    check(out.dtype == torch.int32, f"INT output dtype {out.dtype}")
    check(torch.equal(outs[0], outs[1]), "two INT calls differ")
    check(torch.equal(out_frames, out), "int_frames differs from int")
    spread = np.linspace(0, S_MAIN - 1, 8).astype(int)
    t0 = time.perf_counter()
    want = np.stack([int_ref.mfcc_int(headline[i], cfg) for i in spread])
    oracle_s = time.perf_counter() - t0
    ndiff = int((out[spread].cpu().numpy() != want).sum())
    print(f"MFCC().int(audio) {tuple(audio.shape)} int16 -> "
          f"{tuple(out.shape)} {out.dtype}: K2 launches {k2_launches} in "
          f"{calls} calls, int_frames K3 launches {k3_launches}; elements "
          f"differing from the oracle on 8 spread streams: {ndiff} of "
          f"{want.size} (oracle {oracle_s:.1f} s on the host)")
    check(ndiff == 0, f"INT path differs from the oracle in {ndiff} elements")
    del outs, out, out_frames

    # -- K2 and K3 times -------------------------------------------------------
    frames_n = S_MAIN * n_frames
    times = {
        "K2 kernel (mfcc_int_fused)":
            time_ms(lambda: int_fused.mfcc_int_fused(audio, cfg)),
        "MFCC().int(audio), K2 route": time_ms(lambda: fe.int(audio)),
        "K2 plain version (int_ops chain)":
            time_ms(lambda: int_fused.mfcc_int_fused_plain(audio, cfg)),
        "K3 kernel (mfcc_int_fused_frames)":
            time_ms(lambda: int_fused.mfcc_int_fused_frames(hframes, cfg)),
        "K3 plain version (int_ops chain)":
            time_ms(lambda: int_fused.mfcc_int_fused_frames_plain(hframes,
                                                                  cfg)),
    }
    for name, ms in times.items():
        print(f"time {name}: {ms:.4f} ms, {frames_n / ms * 1e3:.4e} frames/s "
              f"(S={S_MAIN} x T={T_MAIN}, {frames_n} frames, median of "
              f"{ITERS}; {card})")

    ops = int_fused.int_operators(cfg, dev)
    tables = sum(t.nbytes for t in ops[:5])
    out_bytes = frames_n * cfg.nceptrums * 4
    band = ops.band.cpu()
    k2_ops = (4 * S_MAIN * T_MAIN          # pre-emphasis: >> 5, +, -, sext
              + frames_n * int_ops_per_frame(cfg, band))
    k3_ops = frames_n * int_ops_per_frame(cfg, band)
    k2_bound = bound(audio.nbytes + out_bytes + tables, k2_ops, INT32_OPS)
    k3_bound = bound(hframes.nbytes + out_bytes + tables, k3_ops, INT32_OPS)
    print(f"K2 bound: {audio.nbytes + out_bytes + tables} bytes, "
          f"{k2_ops:.4e} int32 operations -> {k2_bound[0]:.4f} ms "
          f"({k2_bound[1]}); K3 bound: {hframes.nbytes + out_bytes + tables} "
          f"bytes, {k3_ops:.4e} -> {k3_bound[0]:.4f} ms ({k3_bound[1]})")
    return [{
        "name": "int_mfcc audio (K2)", "route": "cuda",
        "source": "mfcc_tpu_torch/csrc/int_mfcc.cu",
        "replaces": "mfcc_tpu/ops/pallas_int.py:1131",
        "launches": k2_launches, "max_abs_err": errs["K2"],
        "ms": times["K2 kernel (mfcc_int_fused)"],
        "plain_ms": times["K2 plain version (int_ops chain)"],
        "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
        "library_ms": None,
    }, {
        "name": "int_mfcc frames (K3)", "route": "cuda",
        "source": "mfcc_tpu_torch/csrc/int_mfcc.cu",
        "replaces": "mfcc_tpu/ops/pallas_int.py:1222",
        "launches": k3_launches, "max_abs_err": errs["K3"],
        "ms": times["K3 kernel (mfcc_int_fused_frames)"],
        "plain_ms": times["K3 plain version (int_ops chain)"],
        "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
        "library_ms": None,
    }]


def k4_run(dev, int_path: bool, S: int, C: int, cfg, steps: int = 4,
           seed: int = 0, dft_passes: int | None = None) -> float:
    """K4 against its plain version over a multi-step run on the card, with
    a reset of every other stream at step 2 (which desynchronizes the carry
    phases); chunks alternate int16 and the state dtype (INT: int32 outside
    int16 range; float: values that are not integers), and the carry and
    chunk layouts rotate.  Every feature slot and every carry are compared:
    INT and carries with ``torch.equal``, float features within KERNEL_TOL.
    With ``dft_passes`` 3 or 4 the float step is the split-DFT step: its
    features within R2_TOL, its carry also equal to K4-float's.
    Returns the float max-abs difference (0 for INT)."""
    from mfcc_tpu_torch.ops import stream_fused
    rng = np.random.default_rng(seed)
    P = cfg.nfft - 1
    sdt = torch.int32 if int_path else torch.float32
    step = (stream_fused.stream_step_int if int_path
            else stream_fused.stream_step_float)
    plain = (stream_fused.stream_step_int_plain if int_path
             else stream_fused.stream_step_float_plain)
    carry = torch.zeros(S, P, dtype=sdt, device=dev)
    count = torch.zeros(S, dtype=torch.int32, device=dev)
    prev = torch.zeros(S, dtype=sdt, device=dev)
    err = 0 if int_path else 0.0
    split = dft_passes in (3, 4)
    kw = {"dft_passes": dft_passes} if split else {}
    tol = R2_TOL if split else KERNEL_TOL
    kind = "INT" if int_path else (f"split {dft_passes}" if split else "float")
    what = f"K4-{kind} S={S} C={C} hop {cfg.hop}"
    for k in range(steps):
        if k % 2 == 0:
            x = rng.integers(-32768, 32768, (S, C)).astype(np.int16)
        elif int_path:
            x = rng.integers(-2 ** 31, 2 ** 31, (S, C)).astype(np.int32)
        else:
            x = (rng.integers(-25000, 25000, (S, C))
                 + rng.random((S, C))).astype(np.float32)
        x = torch.from_numpy(x).to(dev)
        if k == 2:
            count[::2] = 0
            prev[::2] = 0
        ts, layout = k % 2 == 1, ("time", "positions", "stream")[k % 3]
        xin = x.T.contiguous() if layout == "positions" else x
        cin = carry.T.contiguous() if ts else carry
        start = (P - count).to(torch.int32)
        f, nc = step(cin, xin, start, prev, cfg, transposed_state=ts,
                     chunk_layout=layout, **kw)
        fp, ncp = plain(cin, xin, start, prev, cfg, transposed_state=ts,
                        chunk_layout=layout, **kw)
        torch.cuda.synchronize()
        where = f"{what} step {k} ({x.dtype}, {layout}, " \
                f"transposed_state={ts})"
        check(tuple(f.shape) == (S, (C - 1) // cfg.hop + 1, cfg.nceptrums),
              f"{where}: shape {tuple(f.shape)}")
        compare_exact(nc, ncp, f"{where} carry")
        if int_path:
            compare_exact(f, fp, f"{where} features")
        else:
            e = compare(f, fp, f"{where} features")
            check(e <= tol, f"{where}: {e} > {tol}")
            err = max(err, e)
            if split:
                compare_exact(nc, step(cin, xin, start, prev, cfg,
                                       transposed_state=ts,
                                       chunk_layout=layout)[1],
                              f"{where} carry vs K4-float's")
        carry = nc.T if ts else nc
        total = count + C
        n_valid = torch.clamp_min((total - cfg.nfft) // cfg.hop + 1, 0)
        count = (total - n_valid * cfg.hop).to(torch.int32)
        prev = x[:, -1].to(sdt)
    return err


def serving_phases(dev, card: str) -> list[dict]:
    """K4 against its plain version, streaming against batch, K4's times
    at the serving shape, and FeatureServer on the card; returns K4's
    entries of the kernels line."""
    from mfcc_tpu_torch import MFCC, MFCCConfig, StreamingMFCC, FeatureServer
    from mfcc_tpu_torch.ops import fladder, int_fused, stream_fused
    from mfcc_tpu_torch.ref import float_ref, int_ref
    from mfcc_tpu_torch.server import query_status, stream_samples

    # -- K4 vs plain version -------------------------------------------------
    errs = {True: 0, False: 0.0}
    for int_path in (True, False):
        for hop in (170, 160):
            for C in (1, 170, 600, 1024, 2048):
                errs[int_path] = max(errs[int_path], k4_run(
                    dev, int_path, 130, C, MFCCConfig(step=hop),
                    seed=C + hop))
        errs[int_path] = max(errs[int_path], k4_run(
            dev, int_path, S_SERVE, C_SERVE, MFCCConfig(), steps=3, seed=1))
        print(f"K4-{'INT' if int_path else 'float'} vs plain: S=130 x C in "
              "{1, 170, 600, 1024, 2048}, hop 170 and 160, 4 steps each, "
              f"and S={S_SERVE} x C={C_SERVE}: every carry equal, features "
              + ("equal" if int_path else f"max-abs {errs[int_path]:.3e}"))

    # -- streaming equals batch ------------------------------------------------
    cfg = MFCCConfig()
    S = 64
    sig = make_audio(S, 64 * C_SERVE, seed=5).astype(np.int16)
    audio = torch.from_numpy(sig).to(dev)
    fe = MFCC()
    spread = np.linspace(0, S - 1, 8).astype(int)
    launches = {}
    for C, T in ((C_SERVE, sig.shape[1]), (149, T_MAIN)):
        x = audio[:, :T]
        n_full = T // C
        flush = T % C != 0
        k2_int = fe.int(x).cpu().numpy()
        k1_float = fe(x).cpu().numpy()
        for int_path in (True, False):
            zero_counts(fladder, int_fused, stream_fused)
            outs, _ = StreamingMFCC(int_path=int_path).process(x, C)
            torch.cuda.synchronize()
            k4 = "K4-INT" if int_path else "K4-float"
            n = {**stream_fused.LAUNCHES, "K1": fladder.LAUNCHES,
                 "K2/K3": sum(int_fused.LAUNCHES.values())}
            want_n = {"K4-float": 0, "K4-split": 0, "K4-INT": 0, "K1": 0,
                      "K2/K3": int(flush and int_path)}
            want_n[k4] = n_full
            check(n == want_n,
                  f"launches {n} for {n_full} full steps and "
                  f"{int(flush)} flush step")
            if C == C_SERVE:
                launches[int_path] = n[k4]
            kind = "INT" if int_path else "float"
            got = np.stack(outs)
            want = k2_int if int_path else k1_float
            check(got.shape == want.shape, f"streamed {kind} {got.shape} "
                  f"vs batch {want.shape}")
            full = cfg.n_frames(n_full * C)     # frames of full-chunk steps
            if int_path:
                ndiff = int((got != want).sum())
                check(ndiff == 0, f"streamed INT C={C} differs from batch "
                      f"K2 in {ndiff} elements")
                msg = f"equal to batch K2 ({want.size} elements)"
            else:
                check(bool(np.isfinite(got).all()), "non-finite streamed")
                e = float(np.abs(got[:, :full] - want[:, :full]).max())
                same = bool(np.array_equal(got[:, :full], want[:, :full]))
                check(e <= KERNEL_TOL, f"streamed float C={C} vs K1: {e}")
                check(same, f"streamed float C={C}: frames of full steps "
                      f"not bit-identical to batch K1 (max-abs {e})")
                e_all = float(np.abs(got - want).max())
                check(e_all <= GATE, f"streamed float C={C} vs K1: {e_all}")
                oracle = np.stack([float_ref.mfcc_float(sig[i, :T], cfg)
                                   for i in spread])
                e_or = float(np.abs(got[spread] - oracle).max())
                check(e_or <= GATE, f"streamed float vs oracle: {e_or}")
                msg = (f"max-abs vs batch K1 {e:.3e} on the {full} frames "
                       f"of full steps (bit-identical: {same}), {e_all:.3e} "
                       f"on all; vs float64 oracle on 8 spread streams "
                       f"{e_or:.3e} (gate {GATE})")
            print(f"StreamingMFCC(int_path={int_path}).process S={S} x "
                  f"T={T} int16, C={C}: launches {n}; {msg}")
        del k2_int, k1_float

    # -- K4 times at the serving shape -----------------------------------------
    steps = 16
    serve = torch.from_numpy(make_audio(S_SERVE, (steps + 2) * C_SERVE,
                                        seed=6).astype(np.int16)).to(dev)
    chunks = [serve[:, i * C_SERVE:(i + 1) * C_SERVE].contiguous()
              for i in range(steps + 2)]
    entries = []
    for int_path in (False, True):
        kind = "INT" if int_path else "float"
        sm = StreamingMFCC(int_path=int_path)
        state = sm.init(S_SERVE)
        for c in chunks[:2]:                    # a carry of real audio
            _, _, state = sm.step(c, state)
        mask = sm.step(chunks[2], state)[1]
        valid = int(mask.sum())
        start = (cfg.windowlen - 1 - state.count).to(torch.int32)
        args = (state.buffer, chunks[2], start, state.prev, cfg)
        kern = (stream_fused.stream_step_int if int_path
                else stream_fused.stream_step_float)
        plain = (stream_fused.stream_step_int_plain if int_path
                 else stream_fused.stream_step_float_plain)
        k_ms = time_ms(lambda: kern(*args))
        p_ms = time_ms(lambda: plain(*args))

        def chain():
            st = state
            for c in chunks[2:]:
                _, _, st = sm.step(c, st)
        step_ms = time_ms(chain) / steps
        for name, ms in ((f"K4-{kind} kernel", k_ms),
                         (f"K4-{kind} plain version", p_ms),
                         (f"StreamingMFCC({kind}).step, mean of a chain of "
                          f"{steps}", step_ms)):
            print(f"time {name}: {ms:.4f} ms per step, "
                  f"{S_SERVE * C_SERVE / 16000 / (ms / 1e3):.4e} real-time "
                  f"streams (S={S_SERVE} x C={C_SERVE} int16, median of "
                  f"{ITERS}; {card})")
        F = stream_fused.frames_per_step(C_SERVE, cfg)
        P = cfg.windowlen - 1
        nbytes = (chunks[2].nbytes + 2 * S_SERVE * P * 4 + S_SERVE * 8
                  + S_SERVE * F * cfg.nceptrums * 4)
        if int_path:
            ops_ = int_fused.int_operators(cfg, dev)
            nbytes += sum(t.nbytes for t in ops_[:5])
            ops = (valid * int_ops_per_frame(cfg, ops_.band.cpu())
                   + 4 * S_SERVE * C_SERVE)
            b_ms, b_by = bound(nbytes, ops, INT32_OPS)
        else:
            ops_ = fladder.default_operators(cfg, dev)
            nbytes += sum(t.nbytes for t in ops_)
            ops = (valid * k1_flops_per_frame(cfg, ops_.band.cpu())
                   + 2 * S_SERVE * C_SERVE)
            b_ms, b_by = bound(nbytes, ops, FP64_FLOPS)
        print(f"K4-{kind} bound: {nbytes} bytes, {valid} valid frames "
              f"({valid / S_SERVE:.2f} per stream), {ops:.4e} "
              f"{'int32' if int_path else 'FP64'} operations -> "
              f"{b_ms:.4f} ms ({b_by})")
        entries.append({
            "name": f"stream_step {kind} (K4)", "route": "cuda",
            "source": "mfcc_tpu_torch/csrc/stream_step.cu",
            "replaces": ("mfcc_tpu/ops/pallas_stream.py:502" if int_path
                         else "mfcc_tpu/ops/pallas_stream.py:421"),
            "launches": launches[int_path], "max_abs_err": errs[int_path],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
    del serve, chunks

    # -- FeatureServer on the card ---------------------------------------------
    sigs = make_audio(8, 16 * C_SERVE, seed=7).astype(np.int16)
    for int_path in (True, False):
        kind = "INT" if int_path else "float"
        if int_path:        # 1 s each: the EOF flush takes K3
            local = [sigs[i, : 16000 - 97 * i] for i in range(8)]
            wants = [int_ref.mfcc_int(s_, cfg).astype(np.int16)
                     for s_ in local]
        else:               # whole chunks: every step is a K4 step
            local = list(sigs)
            feats, _ = StreamingMFCC(mel_floor=1.0).process(
                torch.from_numpy(sigs).to(dev), C_SERVE)
            wants = [np.clip(np.round(f), -32768, 32767).astype(np.int16)
                     for f in feats]
        zero_counts(fladder, int_fused, stream_fused)
        srv = FeatureServer(cfg, max_streams=64, chunk=C_SERVE,
                            int_path=int_path, status_port=0).start()
        try:
            host, port = srv.address
            results, errors = [None] * 8, []

            def client(i):
                try:
                    results[i] = stream_samples(
                        host, port, local[i], cfg.nceptrums,
                        expect_frames=len(wants[i]), timeout=60)
                except Exception as e:      # raised in the main thread
                    errors.append((i, repr(e)))

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(8)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=90)
            secs = time.perf_counter() - t0
            check(not errors and not any(t.is_alive() for t in threads),
                  f"{kind} server clients: {errors[:3]}")
            for i in range(8):
                check(results[i] is not None
                      and np.array_equal(results[i], wants[i]),
                      f"{kind} server client {i}: "
                      f"{None if results[i] is None else results[i].shape} "
                      f"vs {wants[i].shape}")
            (stats,) = query_status(*srv.status_address, "STATS",
                                    timeout=10)
            sent = sum(len(w) for w in wants)
            check(stats["frames_tx"] >= sent and stats["steps"] >= 1,
                  f"STATS {stats} for {sent} frames")
            k4_n = stream_fused.LAUNCHES["K4-INT" if int_path else "K4-float"]
            check(k4_n >= 1, "the server never ran K4")
            print(f"FeatureServer({kind}) on the card, 8 concurrent clients "
                  f"of {len(local[0])} samples: every frame equal to "
                  + ("the INT oracle" if int_path else
                     "clamp(round(StreamingMFCC(mel_floor=1.0)))")
                  + f"; STATS steps {stats['steps']}, frames_tx "
                  f"{stats['frames_tx']} ({sent} expected); K4 launches "
                  f"{k4_n}, K3 {int_fused.LAUNCHES['K3']}; "
                  f"{secs:.2f} s wall")
        finally:
            srv.stop()
    return entries


def r2_flops_per_frame(cfg, passes: int) -> int:
    """Operations of K5's function per frame, as the TPU computes it: the
    split-DFT product, 2 signals x nfft/2 rows x nfft/2 columns x 2 (a
    multiply-add), once per limb product (3 or 4; one f32 product at 6
    passes).  The rest of the tail (window, recombination, power, banded
    mel, log2, DCT) is < 3% of it and not counted."""
    nh = cfg.nfft // 2
    return {3: 3, 4: 4, 6: 1}[passes] * 2 * nh * nh * 2


def r2_bound(nbytes: int, frames: int, cfg, passes: int
             ) -> tuple[float, str, float]:
    """(ms, kind, operations) of K5's function: the limb products at the
    bf16 tensor-core rate (3 and 4 passes), the f32 product at the f32 rate
    (6 passes)."""
    ops = frames * r2_flops_per_frame(cfg, passes)
    ms, by = bound(nbytes, ops, FP32_FLOPS if passes == 6 else BF16_FLOPS)
    return ms, by, ops


def fast_phases(dev, card: str) -> list[dict]:
    """K5 (batch and frames), the split-DFT serving step and K6 against
    their plain versions, the fast and odd-hop main paths with their launch
    counts, the fast gate, and the times; returns their entries of the
    kernels line."""
    from mfcc_tpu_torch import MFCC, MFCCConfig, StreamingMFCC
    from mfcc_tpu_torch.ops import (fladder, float_fused, framing, int_fused,
                                    stream_fused)
    from mfcc_tpu_torch.ref import float_ref
    mods = (fladder, float_fused, int_fused, stream_fused)

    # -- K5 and K5-frames vs their plain versions -------------------------------
    errs = {"K5": 0.0, "K5-frames": 0.0, "K6": 0.0, "K4-split": 0.0}
    for nfft, hop in ((256, 86), (512, 170), (1024, 340)):
        cfg = MFCCConfig(nfft=nfft, step=hop)
        for T in (nfft, nfft + 5 * hop + 3, 16000):
            sig = make_audio(130, T, seed=T + nfft)
            for passes in (3, 4, 6):
                for x, floor in ((torch.from_numpy(sig.astype(np.int16)), 0.0),
                                 (torch.from_numpy(sig), 0.0),
                                 (torch.zeros(2, T), 1.0)):
                    x = x.to(dev)
                    got = float_fused.mfcc_radix2(x, cfg, dft_passes=passes,
                                                  mel_floor=floor)
                    want = float_fused.mfcc_radix2_plain(
                        x, cfg, dft_passes=passes, mel_floor=floor)
                    torch.cuda.synchronize()
                    e = compare(got, want, f"K5 nfft {nfft} T={T} passes "
                                f"{passes} {x.dtype} floor {floor}")
                    check(e <= R2_TOL, f"K5 nfft {nfft} T={T} passes "
                          f"{passes}: {e} > {R2_TOL}")
                    errs["K5"] = max(errs["K5"], e)
                frames = framing.extract_frames(framing.preemphasis(
                    torch.from_numpy(sig).to(dev)), nfft, hop)
                got = float_fused.mfcc_frames_float(frames, cfg,
                                                    dft_passes=passes)
                want = float_fused.mfcc_frames_float_plain(frames, cfg,
                                                           dft_passes=passes)
                torch.cuda.synchronize()
                e = compare(got, want, f"K5-frames nfft {nfft} T={T} passes "
                            f"{passes}")
                check(e <= R2_TOL, f"K5-frames nfft {nfft}: {e} > {R2_TOL}")
                errs["K5-frames"] = max(errs["K5-frames"], e)
    print(f"K5 vs plain: S=130 x T in {{nfft, nfft+5*hop+3, 16000}}, nfft "
          f"256/512/1024, passes 3/4/6, int16, f32 and silent with "
          f"mel_floor=1: max-abs {errs['K5']:.3e}; K5-frames on the same "
          f"frames {errs['K5-frames']:.3e} (tolerance {R2_TOL})")

    # -- K6 vs its plain version ------------------------------------------------
    for step in (171, 165, 341):
        cfg = MFCCConfig(step=step)
        x = torch.from_numpy(make_audio(130, 16000, seed=step)).to(dev)
        for xi in (x.to(torch.int16), x):
            got = float_fused.mfcc_recomp_t(xi, cfg)
            want = float_fused.mfcc_recomp_t_plain(xi, cfg)
            torch.cuda.synchronize()
            e = compare(got, want, f"K6 hop {step} {xi.dtype}")
            check(e <= KERNEL_TOL, f"K6 hop {step}: {e} > {KERNEL_TOL}")
            errs["K6"] = max(errs["K6"], e)
    print(f"K6 vs plain (K1's kernel at an odd hop): S=130 x 1 s, hop 171, "
          f"165 and 341, int16 and f32: max-abs {errs['K6']:.3e}")

    # -- the split-DFT step vs its plain version ----------------------------------
    for passes in (3, 4):
        for C in (1, 170, 600, 1024, 2048):
            errs["K4-split"] = max(errs["K4-split"], k4_run(
                dev, False, 130, C, MFCCConfig(), seed=C + passes,
                dft_passes=passes))
    errs["K4-split"] = max(errs["K4-split"], k4_run(
        dev, False, S_SERVE, C_SERVE, MFCCConfig(), steps=3, seed=2,
        dft_passes=3))
    print(f"K4-split vs plain: S=130 x C in {{1, 170, 600, 1024, 2048}}, "
          f"passes 3 and 4, 4 steps each over every layout, and S={S_SERVE} x "
          f"C={C_SERVE}: every carry equal to the plain version's and to "
          f"K4-float's, features max-abs {errs['K4-split']:.3e}")

    # -- the fast gate on the JAX bench's gate input --------------------------------
    cfg = MFCCConfig()
    gate_in = make_audio(2, 512 + 4 * 170, seed=7)
    want = np.stack([float_ref.mfcc_float(s_, cfg) for s_ in gate_in])
    g = torch.from_numpy(gate_in.astype(np.int16)).to(dev)
    gfr = framing.extract_frames(framing.preemphasis(
        torch.from_numpy(gate_in).to(dev)), 512, cfg.hop).contiguous()
    streamed, _ = StreamingMFCC(precision="fast").process(g, 298)
    readings = {
        "K5 3 passes": float_fused.mfcc_radix2(g, cfg, dft_passes=3),
        "K5-frames 3 passes": float_fused.mfcc_frames_float(gfr, cfg,
                                                            dft_passes=3),
        "streamed fast (C=298)": torch.from_numpy(np.stack(streamed)),
    }
    for name, out in readings.items():
        e = float(np.abs(out.cpu().numpy() - want).max())
        print(f"fast gate input (make_audio(2, 1192, seed=7)): {name} vs "
              f"float64 oracle {e:.3e} (gate {FAST_GATE})")
        check(bool(torch.isfinite(out).all()) and e <= FAST_GATE,
              f"fast gate: {name} {e} > {FAST_GATE}")

    # -- the fast and odd-hop main paths --------------------------------------------
    sig = make_audio(S_MAIN, T_MAIN)
    audio = torch.from_numpy(sig.astype(np.int16)).to(dev)
    spread = np.linspace(0, S_MAIN - 1, 8).astype(int)
    want = np.stack([float_ref.mfcc_float(sig[i], cfg) for i in spread])
    n_frames = cfg.n_frames(T_MAIN)
    fe = MFCC(precision="fast")
    check(fe.window.device.type == "cuda", "MFCC(precision='fast') on "
          f"{fe.window.device}")
    calls = 2
    zero_counts(*mods)
    outs = [fe(audio) for _ in range(calls)]
    torch.cuda.synchronize()
    k5_launches = float_fused.LAUNCHES["K5"]
    check(k5_launches == calls and fladder.LAUNCHES == 0
          and float_fused.LAUNCHES["K6"] == 0,
          f"MFCC(precision='fast') launches {float_fused.LAUNCHES}, K1 "
          f"{fladder.LAUNCHES} for {calls} calls")
    out = outs[0]
    check(tuple(out.shape) == (S_MAIN, n_frames, cfg.nceptrums)
          and out.dtype == torch.float32, f"fast output {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite fast cepstra")
    check(torch.equal(outs[0], outs[1]), "two fast calls differ")
    e3 = float(np.abs(out[spread].cpu().numpy() - want).max())
    k5_6 = float_fused.mfcc_radix2(audio, cfg, dft_passes=6)
    e6 = float(np.abs(k5_6[spread].cpu().numpy() - want).max())
    print(f"MFCC(precision='fast')(audio) {tuple(audio.shape)} int16 -> "
          f"{tuple(out.shape)}: K5 launches {k5_launches} in {calls} calls, "
          f"K1 {fladder.LAUNCHES}; max-abs vs float64 oracle on 8 spread "
          f"streams {e3:.3e} (3 passes; the JAX kernel reads 1.2e-2 here, "
          f"gate {FAST_LONG_GATE}), K5 at 6 passes {e6:.3e}")
    check(e3 <= FAST_LONG_GATE, f"fast on the spread streams: {e3}")
    del outs, k5_6

    hframes = framing.extract_frames(framing.preemphasis(
        audio.to(torch.float32)), 512, cfg.hop).contiguous()
    zero_counts(*mods)
    out_frames = fe.frames(hframes)
    torch.cuda.synchronize()
    kf_launches = float_fused.LAUNCHES["K5-frames"]
    check(kf_launches == 1 and float_fused.LAUNCHES["K5"] == 0,
          f"MFCC(precision='fast').frames launches {float_fused.LAUNCHES}")
    ef = compare(out_frames, out, "K5-frames vs K5 on the headline")
    check(ef <= R2_TOL, f"K5-frames vs K5 on the headline: {ef}")
    print(f"MFCC(precision='fast').frames {tuple(hframes.shape)} f32 "
          f"({hframes.nbytes / 1e9:.2f} GB): K5-frames launches "
          f"{kf_launches}; max-abs vs batch K5 {ef:.3e}")
    del out_frames, out

    cfg171 = MFCCConfig(step=171)
    fe171 = MFCC(cfg171)
    zero_counts(*mods)
    odd = fe171(audio)
    torch.cuda.synchronize()
    k6_launches = float_fused.LAUNCHES["K6"]
    check(k6_launches == 1 and fladder.LAUNCHES == 0,
          f"MFCC(step=171) launches {float_fused.LAUNCHES}, K1 "
          f"{fladder.LAUNCHES}")
    n171 = cfg171.n_frames(T_MAIN)
    check(tuple(odd.shape) == (S_MAIN, n171, cfg.nceptrums)
          and bool(torch.isfinite(odd).all()), f"K6 output {odd.shape}")
    want171 = np.stack([float_ref.mfcc_float(sig[i], cfg171) for i in spread])
    e171 = float(np.abs(odd[spread].cpu().numpy() - want171).max())
    print(f"MFCC(MFCCConfig(step=171))(audio) -> {tuple(odd.shape)}: K6 "
          f"launches {k6_launches}, K1 {fladder.LAUNCHES}; max-abs vs float64 "
          f"oracle on 8 spread streams {e171:.3e} (gate {GATE})")
    check(e171 <= GATE, f"K6 gate: {e171} > {GATE}")
    del odd

    # -- K5, K5-frames and K6 vs their plain versions at the headline shape -----------
    headline = [(f"K5 {p} passes", "K5", R2_TOL, audio,
                 lambda x, p=p: float_fused.mfcc_radix2(x, cfg, dft_passes=p),
                 lambda x, p=p: float_fused.mfcc_radix2_plain(
                     x, cfg, dft_passes=p)) for p in (3, 6)]
    headline += [
        ("K5-frames 3 passes", "K5-frames", R2_TOL, hframes,
         lambda x: float_fused.mfcc_frames_float(x, cfg, dft_passes=3),
         lambda x: float_fused.mfcc_frames_float_plain(x, cfg,
                                                       dft_passes=3)),
        ("K6 hop 171", "K6", KERNEL_TOL, audio,
         lambda x: float_fused.mfcc_recomp_t(x, cfg171),
         lambda x: float_fused.mfcc_recomp_t_plain(x, cfg171))]
    for name, key, tol, x, kern, plain in headline:
        got, want_p = kern(x), plain(x)
        torch.cuda.synchronize()
        e = compare(got, want_p, f"{name} at the headline shape")
        print(f"{name} vs plain at the headline shape {tuple(x.shape)} "
              f"{str(x.dtype)[6:]} -> {tuple(got.shape)}: max-abs {e:.3e} "
              f"(tolerance {tol})")
        check(e <= tol, f"{name} at the headline shape: {e} > {tol}")
        errs[key] = max(errs[key], e)
        del got, want_p

    # -- streamed fast: bit-identical to batch K5 -------------------------------------
    S = 64
    ssig = make_audio(S, 64 * C_SERVE, seed=5).astype(np.int16)
    saudio = torch.from_numpy(ssig).to(dev)
    batch = float_fused.mfcc_radix2(saudio, cfg, dft_passes=3).cpu().numpy()
    zero_counts(*mods)
    outs, _ = StreamingMFCC(precision="fast").process(saudio, C_SERVE)
    torch.cuda.synchronize()
    split_launches = stream_fused.LAUNCHES["K4-split"]
    n = {**stream_fused.LAUNCHES, "K1": fladder.LAUNCHES,
         "K5": float_fused.LAUNCHES["K5"]}
    check(n == {"K4-split": 64, "K4-float": 0, "K4-INT": 0, "K1": 0,
                "K5": 0},
          f"streamed fast launches {n} for 64 full steps")
    got = np.stack(outs)
    check(got.shape == batch.shape and bool(np.isfinite(got).all()),
          f"streamed fast {got.shape} vs batch {batch.shape}")
    same = bool(np.array_equal(got, batch))
    es = float(np.abs(got - batch).max())
    check(es <= 5e-5, f"streamed fast vs batch K5: {es}")
    sp = np.linspace(0, S - 1, 8).astype(int)
    eso = float(np.abs(got[sp] - np.stack(
        [float_ref.mfcc_float(ssig[i], cfg) for i in sp])).max())
    print(f"StreamingMFCC(precision='fast').process S={S} x "
          f"T={ssig.shape[1]} int16, C={C_SERVE}: launches {n}; vs batch K5 "
          f"at 3 passes bit-identical: {same} (max-abs {es:.3e}); vs float64 "
          f"oracle on 8 spread streams {eso:.3e} (read, not gated: the JAX "
          f"kernel reads 0.17 on these streams, "
          f"tests/test_torch_float_fused.py)")
    del batch, outs, saudio

    # -- times at the headline shape ----------------------------------------------------
    frames_n = S_MAIN * n_frames
    fe_high = MFCC()
    times = {}
    for name, fn in (
            ("K1 kernel (mfcc_float_ladder), hop 170",
             lambda: fladder.mfcc_float_ladder(audio, cfg)),
            ("K5 kernel, 3 passes",
             lambda: float_fused.mfcc_radix2(audio, cfg, dft_passes=3)),
            ("K5 kernel, 6 passes",
             lambda: float_fused.mfcc_radix2(audio, cfg, dft_passes=6)),
            ("MFCC(precision='fast')(audio), K5 route", lambda: fe(audio)),
            ("MFCC()(audio), K1 route", lambda: fe_high(audio)),
            ("K5 plain version, 3 passes",
             lambda: float_fused.mfcc_radix2_plain(audio, cfg,
                                                   dft_passes=3)),
            ("K5-frames kernel, 3 passes",
             lambda: float_fused.mfcc_frames_float(hframes, cfg,
                                                   dft_passes=3)),
            ("K5-frames plain version, 3 passes",
             lambda: float_fused.mfcc_frames_float_plain(hframes, cfg,
                                                         dft_passes=3))):
        times[name] = time_ms(fn)
        print(f"time {name}: {times[name]:.4f} ms, "
              f"{frames_n / times[name] * 1e3:.4e} frames/s (S={S_MAIN} x "
              f"T={T_MAIN} int16, {frames_n} frames, median of {ITERS}; "
              f"{card})")
    del hframes
    frames171 = S_MAIN * n171
    for name, fn in (
            ("K6 kernel, hop 171",
             lambda: float_fused.mfcc_recomp_t(audio, cfg171)),
            ("K6 plain version, hop 171",
             lambda: float_fused.mfcc_recomp_t_plain(audio, cfg171))):
        times[name] = time_ms(fn)
        print(f"time {name}: {times[name]:.4f} ms, "
              f"{frames171 / times[name] * 1e3:.4e} frames/s (S={S_MAIN} x "
              f"T={T_MAIN} int16, {frames171} frames, median of {ITERS}; "
              f"{card})")

    ops = float_fused.default_operators(cfg, dev)
    tables = sum(t.nbytes for t in ops if t is not ops.dft)
    out_bytes = frames_n * cfg.nceptrums * 4
    k5 = r2_bound(audio.nbytes + out_bytes + tables, frames_n, cfg, 3)
    k5_6 = r2_bound(audio.nbytes + out_bytes + tables, frames_n, cfg, 6)
    kf = r2_bound(frames_n * 512 * 4 + out_bytes + tables, frames_n, cfg, 3)
    lops = fladder.default_operators(cfg171, dev)
    k6_nbytes = (audio.nbytes + frames171 * cfg.nceptrums * 4
                 + sum(t.nbytes for t in lops))
    k6_ops = frames171 * k1_flops_per_frame(cfg171, lops.band.cpu())
    k6 = bound(k6_nbytes, k6_ops, FP64_FLOPS)
    print(f"K5 bound, 3 passes: {k5[2]:.4e} operations of bf16 limb products "
          f"at {BF16_FLOPS:.3e}/s -> {k5[0]:.4f} ms ({k5[1]}); 6 passes: "
          f"{k5_6[2]:.4e} f32 at {FP32_FLOPS:.3e}/s -> {k5_6[0]:.4f} ms "
          f"({k5_6[1]}); K5-frames, 3 passes: {kf[0]:.4f} ms ({kf[1]}); K6: "
          f"{k6_nbytes} bytes, {k6_ops:.4e} FP64 operations -> {k6[0]:.4f} ms "
          f"({k6[1]})")

    # -- the split-DFT step at the serving shape -------------------------------------------
    steps = 16
    serve = torch.from_numpy(make_audio(S_SERVE, (steps + 2) * C_SERVE,
                                        seed=6).astype(np.int16)).to(dev)
    chunks = [serve[:, i * C_SERVE:(i + 1) * C_SERVE].contiguous()
              for i in range(steps + 2)]
    sm = StreamingMFCC(precision="fast")
    state = sm.init(S_SERVE)
    for c in chunks[:2]:
        _, _, state = sm.step(c, state)
    valid = int(sm.step(chunks[2], state)[1].sum())
    start = (cfg.windowlen - 1 - state.count).to(torch.int32)
    args = (state.buffer, chunks[2], start, state.prev, cfg)
    s_ms = time_ms(lambda: stream_fused.stream_step_float(*args,
                                                          dft_passes=3))
    sp_ms = time_ms(lambda: stream_fused.stream_step_float_plain(
        *args, dft_passes=3))
    k4f_ms = time_ms(lambda: stream_fused.stream_step_float(*args))

    def chain():
        st = state
        for c in chunks[2:]:
            _, _, st = sm.step(c, st)
    step_ms = time_ms(chain) / steps
    for name, ms in (("K4-split kernel, 3 passes", s_ms),
                     ("K4-split plain version, 3 passes", sp_ms),
                     ("K4-float kernel (same inputs)", k4f_ms),
                     (f"StreamingMFCC(precision='fast').step, mean of a "
                      f"chain of {steps}", step_ms)):
        print(f"time {name}: {ms:.4f} ms per step, "
              f"{S_SERVE * C_SERVE / 16000 / (ms / 1e3):.4e} real-time "
              f"streams (S={S_SERVE} x C={C_SERVE} int16, median of "
              f"{ITERS}; {card})")
    P = cfg.windowlen - 1
    F = stream_fused.frames_per_step(C_SERVE, cfg)
    s_bytes = (chunks[2].nbytes + 2 * S_SERVE * P * 4 + S_SERVE * 8
               + S_SERVE * F * cfg.nceptrums * 4 + tables)
    ks = r2_bound(s_bytes, valid, cfg, 3)
    print(f"K4-split bound: {s_bytes} bytes, {valid} valid frames, "
          f"{ks[2]:.4e} bf16 limb-product operations -> {ks[0]:.4f} ms "
          f"({ks[1]})")
    del serve, chunks, state, args

    return [
        kernel_entry("radix2 split-DFT audio, 3 passes (K5)",
                     "mfcc_tpu_torch/csrc/float_fused.cu",
                     "mfcc_tpu/ops/pallas_mfcc.py:1333", k5_launches,
                     errs["K5"], times["K5 kernel, 3 passes"],
                     times["K5 plain version, 3 passes"], k5),
        kernel_entry("radix2 split-DFT frames, 3 passes (K5-frames)",
                     "mfcc_tpu_torch/csrc/float_fused.cu",
                     "mfcc_tpu/ops/pallas_mfcc.py:1256", kf_launches,
                     errs["K5-frames"], times["K5-frames kernel, 3 passes"],
                     times["K5-frames plain version, 3 passes"], kf),
        kernel_entry("recomp_t odd hop on K1's kernel (K6)",
                     "mfcc_tpu_torch/csrc/fladder.cu",
                     "mfcc_tpu/ops/pallas_mfcc.py:840", k6_launches,
                     errs["K6"], times["K6 kernel, hop 171"],
                     times["K6 plain version, hop 171"], k6),
        kernel_entry("stream_step split-DFT, 3 passes (K4-split)",
                     "mfcc_tpu_torch/csrc/stream_step.cu",
                     "mfcc_tpu/ops/pallas_stream.py:421", split_launches,
                     errs["K4-split"], s_ms, sp_ms, ks),
    ]


def k7_flops_per_frame(cfg, band: torch.Tensor, wire_grid: bool = True
                       ) -> int:
    """FP64 operations of csrc/f64ish.cu per frame: K1's count
    (``k1_flops_per_frame``) with the ingest taken as K7 does it: per
    sample the grid step (multiply, rint, multiply) when ``wire_grid`` and
    the window, 8 (2) per packed point instead of K1's 6.  The batch
    entry's f32 emphasis (2 per sample) runs on the f32 pipe, whose peak is
    twice the FP64 one, so it never sets the bound and is not counted."""
    m = cfg.nfft // 2
    return k1_flops_per_frame(cfg, band) - 6 * m + (8 if wire_grid else 2) * m


def gate_units(got: np.ndarray, want: np.ndarray) -> float:
    """The f64ish metric (``bench.f64ish_gate_err``): the max over elements
    of |got - want| / max(1e-5, 2 ulp(want)); inf unless finite; <= 1.0
    passes."""
    tol = np.maximum(F64ISH_GATE, 2 * np.abs(want) * np.finfo(np.float32).eps)
    err = float((np.abs(got - want) / tol).max())
    return err if np.isfinite(err) else float("inf")


def tie_audio(S: int, T: int, seed: int) -> np.ndarray:
    """Small f32 samples whose emphasized values sit exactly on the grid's
    ties at every other sample: integers n at even t and odd multiples of
    1/64 at odd t, so y = x - (31/32) n = odd/64 and y*32 = k + 0.5 (all
    exact in f32).  Small, so that a sample moved by 1/32 moves the
    cepstra far past KERNEL_TOL."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 9, (S, T)).astype(np.float64)
    x[:, 1::2] = (2 * rng.integers(-32, 32, (S, T // 2)) + 1) / 64
    return x.astype(np.float32)


def f64ish_phases(dev, card: str) -> list[dict]:
    """K7 and K7-frames against their plain versions, the f64ish gate, the
    f64ish batch, frames and streaming main paths with their launch counts,
    the split and segmented chain, and the times; returns K7's entries of
    the kernels line."""
    from mfcc_tpu_torch import MFCC, MFCCConfig, StreamingMFCC
    from mfcc_tpu_torch.ops import (f64ish, fladder, float_fused, float_ops,
                                    framing, int_fused, stream_fused)
    from mfcc_tpu_torch.ref import float_ref
    mods = (f64ish, fladder, float_fused, int_fused, stream_fused)

    # -- K7 and K7-frames vs their plain versions -----------------------------------
    errs = {"K7": 0.0, "K7-frames": 0.0}
    for nfft, hop in ((256, 86), (512, 170), (1024, 340)):
        cfg = MFCCConfig(nfft=nfft, step=hop)
        sig = make_audio(130, 16000, seed=nfft + 1)
        norm = sig / np.float32(32768)
        inputs = [
            ("int16", sig.astype(np.int16), True),
            ("f32 on the grid", sig, True),
            ("[-1, 1] f32, wire_grid", norm, True),
            ("[-1, 1] f32, wire_grid=False", norm, False),
            ("2^20-scaled f32, wire_grid=False",
             (sig * np.float32(2.0 ** 20)).astype(np.float32), False),
            ("x*32 at k+0.5 on every other sample", tie_audio(130, 16000,
                                                              nfft), True),
        ]
        for name, x, wg in inputs:
            xt = torch.from_numpy(x).to(dev)
            got = f64ish.mfcc_f64ish(xt, cfg, wire_grid=wg)
            want = f64ish.mfcc_batch_f64ish_plain(xt, cfg, wire_grid=wg)
            torch.cuda.synchronize()
            e = compare(got, want, f"K7 nfft {nfft} {name}")
            print(f"K7 vs plain, nfft {nfft}/{hop}, {name} {tuple(xt.shape)}: "
                  f"max-abs {e:.3e}")
            check(e <= KERNEL_TOL, f"K7 nfft {nfft} {name}: {e} > "
                  f"{KERNEL_TOL}")
            errs["K7"] = max(errs["K7"], e)
            if name == "int16":
                same = torch.equal(got, fladder.mfcc_float_ladder(xt, cfg))
                print(f"K7 on int16 bit-identical to K1, nfft {nfft}: {same}")
                check(same, f"K7 on int16 differs from K1, nfft {nfft}")
            if name.startswith("x*32"):
                # the grid step rounds ties half to even, as the plain version
                shifted = f64ish.mfcc_f64ish(xt, cfg, wire_grid=False)
                moved = float((shifted - got).abs().max())
                check(moved > 100 * KERNEL_TOL, f"ties moved by {moved}")
        sig_frames = framing.extract_frames(framing.preemphasis(
            torch.from_numpy(norm).to(dev)), nfft, hop).contiguous()
        k = torch.from_numpy(np.random.default_rng(nfft).integers(
            -2 ** 19, 2 ** 19, (2, 9, nfft)).astype(np.float64)).to(dev)
        ties = ((k + 0.5) / 32).to(torch.float32)
        for name, fr, wg in (("[-1, 1] frames, wire_grid", sig_frames, True),
                             ("[-1, 1] frames, wire_grid=False", sig_frames,
                              False),
                             ("frames at x*32 = k+0.5, (2, 9, nfft)", ties,
                              True)):
            got = f64ish.mfcc_f64ish_frames(fr, cfg, wire_grid=wg)
            want = f64ish.mfcc_frames_f64ish_plain(fr, cfg, wire_grid=wg)
            torch.cuda.synchronize()
            e = compare(got, want, f"K7-frames nfft {nfft} {name}")
            print(f"K7-frames vs plain, nfft {nfft}, {name}: max-abs {e:.3e}")
            check(e <= KERNEL_TOL, f"K7-frames nfft {nfft} {name}: {e}")
            errs["K7-frames"] = max(errs["K7-frames"], e)
        even = (torch.round(ties.double() * 32) / 32).to(torch.float32)
        check(torch.equal(f64ish.mfcc_f64ish_frames(ties, cfg),
                          f64ish.mfcc_f64ish_frames(even, cfg,
                                                    wire_grid=False)),
              f"K7-frames nfft {nfft}: ties not rounded half to even")

    # -- the f64ish gate -----------------------------------------------------------
    cfg = MFCCConfig()
    gate_in = make_audio(2, 512 + 4 * 170, seed=7)
    want_g = np.stack([float_ref.mfcc_float(s_, cfg) for s_ in gate_in])
    g = torch.from_numpy(gate_in.astype(np.int16)).to(dev)
    gfr = framing.extract_frames(framing.preemphasis(
        torch.from_numpy(gate_in).to(dev)), 512, cfg.hop).contiguous()
    for name, out in (("K7", f64ish.mfcc_f64ish(g, cfg)),
                      ("K7-frames", f64ish.mfcc_f64ish_frames(gfr, cfg))):
        u = gate_units(out.cpu().numpy(), want_g)
        print(f"f64ish gate input (make_audio(2, 1192, seed=7)): {name} "
              f"{u:.4f} gate units (<= 1.0 passes)")
        check(u <= 1.0, f"f64ish gate: {name} {u}")

    # -- the f64ish main paths: MFCC(precision="f64ish") and its frames ------------
    sig = make_audio(S_MAIN, T_MAIN)
    audio = torch.from_numpy(sig.astype(np.int16)).to(dev)
    spread = np.linspace(0, S_MAIN - 1, 8).astype(int)
    want = np.stack([float_ref.mfcc_float(sig[i], cfg) for i in spread])
    n_frames = cfg.n_frames(T_MAIN)
    fe = MFCC(precision="f64ish")
    check(fe.window.device.type == "cuda", "MFCC(precision='f64ish') on "
          f"{fe.window.device}")
    calls = 2
    zero_counts(*mods)
    outs = [fe(audio) for _ in range(calls)]
    torch.cuda.synchronize()
    k7_launches = f64ish.LAUNCHES["K7"]
    check(k7_launches == calls and fladder.LAUNCHES == 0
          and f64ish.LAUNCHES["K7-frames"] == 0,
          f"MFCC(precision='f64ish') launches {f64ish.LAUNCHES}, K1 "
          f"{fladder.LAUNCHES} for {calls} calls")
    out = outs[0]
    check(tuple(out.shape) == (S_MAIN, n_frames, cfg.nceptrums)
          and out.dtype == torch.float32, f"f64ish output {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite f64ish cepstra")
    check(torch.equal(outs[0], outs[1]), "two f64ish calls differ")
    u = gate_units(out[spread].cpu().numpy(), want)
    e_or = float(np.abs(out[spread].cpu().numpy() - want).max())
    print(f"MFCC(precision='f64ish')(audio) {tuple(audio.shape)} int16 -> "
          f"{tuple(out.shape)}: K7 launches {k7_launches} in {calls} calls, "
          f"K1 {fladder.LAUNCHES}; vs float64 oracle on 8 spread streams "
          f"{u:.4f} gate units, max-abs {e_or:.3e}")
    check(u <= 1.0, f"f64ish gate on the spread streams: {u}")
    k1_same = torch.equal(out, fladder.mfcc_float_ladder(audio, cfg))
    print(f"K7 on the headline int16 bit-identical to K1: {k1_same}")
    check(k1_same, "K7 on the headline int16 differs from K1")
    del outs

    hframes = framing.extract_frames(framing.preemphasis(
        audio.to(torch.float32)), 512, cfg.hop).contiguous()
    zero_counts(*mods)
    out_frames = fe.frames(hframes)
    torch.cuda.synchronize()
    kf_launches = f64ish.LAUNCHES["K7-frames"]
    check(kf_launches == 1 and f64ish.LAUNCHES["K7"] == 0,
          f"MFCC(precision='f64ish').frames launches {f64ish.LAUNCHES}")
    ef = compare(out_frames, out, "K7-frames vs K7 on the headline")
    check(ef <= KERNEL_TOL, f"K7-frames vs K7 on the headline: {ef}")
    print(f"MFCC(precision='f64ish').frames {tuple(hframes.shape)} f32: "
          f"K7-frames launches {kf_launches}; vs batch K7 max-abs {ef:.3e} "
          f"(bit-identical: {torch.equal(out_frames, out)})")
    del out_frames

    # -- K7 and K7-frames vs their plain versions at the headline shape ------------
    for name, key, x, kern, plain in (
            ("K7", "K7", audio, f64ish.mfcc_f64ish,
             f64ish.mfcc_batch_f64ish_plain),
            ("K7-frames", "K7-frames", hframes, f64ish.mfcc_f64ish_frames,
             f64ish.mfcc_frames_f64ish_plain)):
        got, want_p = kern(x, cfg), plain(x, cfg)
        torch.cuda.synchronize()
        e = compare(got, want_p, f"{name} at the headline shape")
        print(f"{name} vs plain at the headline shape {tuple(x.shape)}: "
              f"max-abs {e:.3e} (tolerance {KERNEL_TOL})")
        check(e <= KERNEL_TOL, f"{name} at the headline shape: {e}")
        errs[key] = max(errs[key], e)
        del got, want_p

    # -- streamed f64ish: K7-frames once per step, against batch K7 -----------------
    S = 64
    ssig = make_audio(S, 64 * C_SERVE, seed=5)
    saudio = torch.from_numpy(ssig.astype(np.int16)).to(dev)
    for C, T in ((C_SERVE, ssig.shape[1]), (149, T_MAIN)):
        x = saudio[:, :T]
        batch = f64ish.mfcc_f64ish(x, cfg).cpu().numpy()
        steps = -(-T // C)
        zero_counts(*mods)
        outs, _ = StreamingMFCC(precision="f64ish").process(x, C)
        torch.cuda.synchronize()
        n = {**f64ish.LAUNCHES, **stream_fused.LAUNCHES,
             "K1": fladder.LAUNCHES}
        check(n == {"K7": 0, "K7-frames": steps, "K4-float": 0,
                    "K4-split": 0, "K4-INT": 0, "K1": 0},
              f"streamed f64ish launches {n} for {steps} steps")
        got = np.stack(outs)
        check(got.shape == batch.shape and bool(np.isfinite(got).all()),
              f"streamed f64ish {got.shape} vs batch {batch.shape}")
        es = float(np.abs(got - batch).max())
        check(es <= KERNEL_TOL, f"streamed f64ish C={C} vs batch K7: {es}")
        print(f"StreamingMFCC(precision='f64ish').process S={S} x T={T} "
              f"int16, C={C} ({T // C} full steps, {int(T % C != 0)} flush): "
              f"launches {n}; vs batch K7 max-abs {es:.3e} (bit-identical: "
              f"{bool(np.array_equal(got, batch))})")
    del saudio, batch, outs

    # -- the split and segmented chain -----------------------------------------------
    for name, kw in (("MFCC(precision='split')", dict(precision="split")),
                     ("MFCC(method='segmented')", dict(method="segmented")),
                     ("MFCC(method='segmented', precision='split')",
                      dict(method="segmented", precision="split"))):
        fe_s = MFCC(**kw)
        e = float(np.abs(fe_s(g).cpu().numpy() - want_g).max())
        print(f"{name} on the f64ish gate input vs float64 oracle: max-abs "
              f"{e:.3e} (gate {GATE})")
        check(e <= GATE, f"{name}: {e} > {GATE}")
    split_out = MFCC(precision="split")(audio)
    e_split = float(np.abs(split_out[spread].cpu().numpy() - want).max())
    print(f"MFCC(precision='split')(audio) on the headline: max-abs vs "
          f"float64 oracle on 8 spread streams {e_split:.3e} (read, not "
          f"gated: bf16 limbs keep ~16 mantissa bits)")
    del split_out

    # -- times ---------------------------------------------------------------------------
    T_B = 512 + 93 * 170                        # the JAX bench's f64ish shape
    bench = torch.from_numpy(make_audio(512, T_B, seed=3).astype(
        np.int16)).to(dev)
    bframes = framing.extract_frames(framing.preemphasis(
        bench.to(torch.float32)), 512, cfg.hop).contiguous()
    times, shapes = {}, {}
    for tag, a, fr in (("headline", audio, hframes), ("bench", bench,
                                                      bframes)):
        nf = fr.shape[0] * fr.shape[1]
        shapes[tag] = (f"S={a.shape[0]} x T={a.shape[1]} int16, {nf} "
                       f"frames", nf)
        for name, fn in (
                ("K7 kernel", lambda a=a: f64ish.mfcc_f64ish(a, cfg)),
                ("K7 plain version",
                 lambda a=a: f64ish.mfcc_batch_f64ish_plain(a, cfg)),
                ("MFCC(precision='f64ish')(audio), K7 route",
                 lambda a=a: fe(a)),
                ("K7-frames kernel",
                 lambda fr=fr: f64ish.mfcc_f64ish_frames(fr, cfg)),
                ("K7-frames plain version",
                 lambda fr=fr: f64ish.mfcc_frames_f64ish_plain(fr, cfg)),
                ("K1 kernel (mfcc_float_ladder)",
                 lambda a=a: fladder.mfcc_float_ladder(a, cfg))):
            times[(tag, name)] = ms = time_ms(fn)
            print(f"time {name}: {ms:.4f} ms, {nf / ms * 1e3:.4e} frames/s "
                  f"({shapes[tag][0]}, median of {ITERS}; {card})")
    del hframes, bframes, bench

    ops = fladder.default_operators(cfg, dev)
    tables = sum(t.nbytes for t in ops)
    nf = shapes["headline"][1]
    out_bytes = nf * cfg.nceptrums * 4
    flops = nf * k7_flops_per_frame(cfg, ops.band.cpu())
    k7_b = bound(audio.nbytes + out_bytes + tables, flops, FP64_FLOPS)
    kf_b = bound(nf * cfg.nfft * 4 + out_bytes + tables, flops, FP64_FLOPS)
    print(f"K7 bound: {audio.nbytes + out_bytes + tables} bytes, {flops:.4e} "
          f"FP64 operations -> {k7_b[0]:.4f} ms ({k7_b[1]}); K7-frames: "
          f"{nf * cfg.nfft * 4 + out_bytes + tables} bytes -> {kf_b[0]:.4f} "
          f"ms ({kf_b[1]})")

    return [kernel_entry(
        f"f64ish {what} ({key})", "mfcc_tpu_torch/csrc/f64ish.cu",
        "mfcc_tpu/ops/pallas_df32.py:351", launches, errs[key],
        times[("headline", f"{key} kernel")],
        times[("headline", f"{key} plain version")], b)
        for what, key, launches, b in (("audio", "K7", k7_launches, k7_b),
                                       ("frames", "K7-frames", kf_launches,
                                        kf_b))]

# K8's entries: (LAUNCHES key, function name, ingest, split, pallas_call of
# the TPU kernel it replaces)
K8_ENTRIES = (
    ("emphasized", "mfcc_emphasized", "emphasized", False,
     "mfcc_tpu/ops/pallas_mfcc.py:182"),
    ("batch", "mfcc_batch_dense", "emphasize", False,
     "mfcc_tpu/ops/pallas_mfcc.py:182"),
    ("raw", "mfcc_raw", "fold", True, "mfcc_tpu/ops/pallas_mfcc.py:316"),
    ("aligned", "mfcc_aligned", "emphasize", True,
     "mfcc_tpu/ops/pallas_mfcc.py:448"),
    ("recomp", "mfcc_recomp", "emphasize", True,
     "mfcc_tpu/ops/pallas_mfcc.py:581"),
    ("seg", "mfcc_seg", "emphasize", True, "mfcc_tpu/ops/pallas_mfcc.py:719"),
    ("fmaj", "mfcc_fmaj", "emphasize", False,
     "mfcc_tpu/ops/pallas_mfcc.py:1467"),
)


def dense_bound(nbytes: int, frames: int, cfg, band: torch.Tensor,
                fold: bool) -> tuple[float, str, float]:
    """(ms, kind, DFT operations) of K8's function: the product's 2 K nfft
    operations a frame (K = nfft, or nfft + 1 folded) at the FP64 tensor
    cores' rate; power (3 per bin), the banded mel sums (2 per weight), a
    log2 per filter and the DCT (2 per weight) at the FP64 rate, the two
    pipes taken as overlapping (the larger time).  The f32 emphasis and the
    limb split run on the f32 pipe and are not counted."""
    K = cfg.nfft + int(fold)
    dft = frames * 2 * K * cfg.nfft
    tail = frames * (3 * cfg.nfft // 2
                     + 2 * int((band[:, 1] - band[:, 0]).sum())
                     + cfg.nfilters + 2 * cfg.nfilters * cfg.nceptrums)
    t_ops = max(dft / FP64_TC_FLOPS, tail / FP64_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return ((t_bytes, "bytes", dft) if t_bytes >= t_ops
            else (t_ops, "operations", dft))


def int_ops_split(cfg, band: torch.Tensor) -> tuple[int, int]:
    """int32 operations per frame of K10's two launches: the front (window,
    the 512-point ladder with all 256 bins live, since it stores them, and
    the power of every bin) and the epilogue (filterbank, log2 and the DCT
    ladder, as ``int_ops_per_frame`` counts them)."""
    nfft = cfg.nfft
    lg = nfft.bit_length() - 1
    live = [True] * (nfft // 2) + [False] * (nfft // 2)
    front = (3 * nfft + ladder_ops(lg, [True] * nfft, [False] * nfft, live,
                                   live) + 4 * (nfft // 2))
    used = [False] * nfft
    for lo, hi in band.tolist():
        used[lo:hi] = [True] * (hi - lo)
    whole = int_ops_per_frame(cfg, band)
    epi = whole - 3 * nfft - 4 * sum(used) - ladder_ops(
        lg, [True] * nfft, [False] * nfft, used, used)
    return front, epi


def legacy_phases(dev, card: str) -> list[dict]:
    """K8's seven entries, K9, K3-v1 and K10 against their plain versions,
    their gates, launch counts and times; returns their entries of the
    kernels line."""
    from mfcc_tpu_torch import MFCCConfig
    from mfcc_tpu_torch.ops import (dense_fused, fladder, float_fused, framing,
                                    int_fused, stream_fused, f64ish)
    from mfcc_tpu_torch.ref import float_ref, int_ref
    mods = (dense_fused, fladder, float_fused, int_fused, stream_fused, f64ish)

    def entry(name):
        return (getattr(dense_fused, name),
                getattr(dense_fused, name + "_plain"))

    def k8_input(x, ingest):
        """The entry's input: emphasized f32 for the emphasized ingest."""
        if ingest == "emphasized":
            return framing.preemphasis(x.to(torch.float32))
        return x

    # -- K8 vs its plain versions ---------------------------------------------------
    errs = {key: 0.0 for key, *_ in K8_ENTRIES}
    for nfft, hop in ((256, 86), (512, 170), (1024, 340)):
        cfg = MFCCConfig(nfft=nfft, step=hop)
        sig = make_audio(64, 16000, seed=nfft + 2)
        rng = np.random.default_rng(nfft)
        inputs = [("int16", torch.from_numpy(sig.astype(np.int16))),
                  ("non-integer f32", torch.from_numpy(
                      sig + rng.random(sig.shape, dtype=np.float32)))]
        for key, name, ingest, _, _ in K8_ENTRIES:
            if key == "aligned" and nfft != 512:
                continue
            kern, plain = entry(name)
            for what, x in inputs:
                xin = k8_input(x.to(dev), ingest)
                got, want = kern(xin, cfg), plain(xin, cfg)
                torch.cuda.synchronize()
                e = compare(got, want, f"K8 {key} nfft {nfft} {what}")
                check(e <= KERNEL_TOL, f"K8 {key} nfft {nfft} {what}: {e}")
                errs[key] = max(errs[key], e)
        print(f"K8 vs plain, nfft {nfft}/{hop}, S=64 x 1 s int16 and "
              f"non-integer f32, every entry: max-abs "
              f"{max(errs.values()):.3e}")
    cfg = MFCCConfig()
    silent = torch.zeros(2, 16000, dtype=torch.int16, device=dev)
    got = dense_fused.mfcc_fmaj(silent, cfg, mel_floor=1.0)
    e = compare(got, dense_fused.mfcc_fmaj_plain(silent, cfg, mel_floor=1.0),
                "K8 fmaj silence, mel_floor=1")
    check(e <= KERNEL_TOL and bool(torch.isfinite(got).all()),
          f"K8 fmaj silence with mel_floor: {e}")
    check(not bool(torch.isfinite(dense_fused.mfcc_fmaj(silent, cfg)).any()),
          "K8 fmaj silence without mel_floor is finite")
    errs["fmaj"] = max(errs["fmaj"], e)
    print(f"K8 fmaj on silence: mel_floor=1.0 finite, {e:.3e} from plain; "
          f"without it non-finite, as in JAX")

    # -- K8 at the headline: kernel vs plain, launches, gates -----------------------
    sig = make_audio(S_MAIN, T_MAIN)
    audio = torch.from_numpy(sig.astype(np.int16)).to(dev)
    n_frames = cfg.n_frames(T_MAIN)
    frames_n = S_MAIN * n_frames
    spread = np.linspace(0, S_MAIN - 1, 8).astype(int)
    want_or = np.stack([float_ref.mfcc_float(sig[i], cfg) for i in spread])
    gate_in = make_audio(2, 512 + 4 * 170, seed=7)
    want_g = np.stack([float_ref.mfcc_float(s_, cfg) for s_ in gate_in])
    g16 = torch.from_numpy(gate_in.astype(np.int16)).to(dev)
    k8_launches = {}
    for key, name, ingest, split, _ in K8_ENTRIES:
        kern, plain = entry(name)
        xin = k8_input(audio, ingest)
        zero_counts(*mods)
        out = kern(xin, cfg)
        torch.cuda.synchronize()
        k8_launches[key] = dense_fused.LAUNCHES[key]
        others = sum(sum(m.LAUNCHES.values()) if isinstance(m.LAUNCHES, dict)
                     else m.LAUNCHES for m in mods) - k8_launches[key]
        check(k8_launches[key] == 1 and others == 0,
              f"K8 {key}: launches {dense_fused.LAUNCHES}, others {others}")
        check(tuple(out.shape) == (S_MAIN, n_frames, cfg.nceptrums)
              and bool(torch.isfinite(out).all()), f"K8 {key} output")
        e = compare(out, plain(xin, cfg), f"K8 {key} at the headline")
        check(e <= KERNEL_TOL, f"K8 {key} at the headline: {e}")
        errs[key] = max(errs[key], e)
        e_or = float(np.abs(out[spread].cpu().numpy() - want_or).max())
        e_g = float(np.abs(kern(k8_input(g16, ingest), cfg).cpu().numpy()
                           - want_g).max())
        gated = not split or key == "raw"
        print(f"dense_fused.{name} ({ingest}, split={split}) "
              f"{tuple(audio.shape)} -> {tuple(out.shape)}: launches "
              f"{k8_launches[key]}; vs plain {e:.3e}; vs float64 oracle on 8 "
              f"spread streams {e_or:.3e} ("
              + (f"gate {GATE}" if gated else "read, not gated") +
              f"), on the gate input {e_g:.3e} (gate {GATE})")
        check(e_g <= GATE, f"K8 {key} on the gate input: {e_g}")
        if gated:
            check(e_or <= GATE, f"K8 {key} on the spread streams: {e_or}")
        del out

    # -- K8 times ---------------------------------------------------------------
    times = {}
    for key, name, ingest, split, _ in K8_ENTRIES:
        kern, plain = entry(name)
        xin = k8_input(audio, ingest)
        times[key] = time_ms(lambda: kern(xin, cfg))
        times[key + " plain"] = time_ms(lambda: plain(xin, cfg))
        print(f"time K8 {key} kernel: {times[key]:.4f} ms "
              f"({frames_n / times[key] * 1e3:.4e} frames/s), plain "
              f"{times[key + ' plain']:.4f} ms (S={S_MAIN} x T={T_MAIN}, "
              f"{frames_n} frames, median of {ITERS}; {card})")
    fr = torch.randn(frames_n, 512, dtype=torch.float64, device=dev)
    op = torch.randn(512, 512, dtype=torch.float64, device=dev)
    gemm_ms = time_ms(lambda: torch.matmul(fr, op))
    del fr, op
    print(f"time torch.matmul float64 ({frames_n} x 512) @ (512 x 512), the "
          f"DFT product only: {gemm_ms:.4f} ms ({card})")
    k1_ms = time_ms(lambda: fladder.mfcc_float_ladder(audio, cfg))
    print(f"time K1 kernel in the same call: {k1_ms:.4f} ms")

    band = dense_fused.dense_operators(cfg, dev, False, False).band.cpu()
    out_bytes = frames_n * cfg.nceptrums * 4
    k8_entries = []
    for key, name, ingest, split, replaces in K8_ENTRIES:
        ops = dense_fused.dense_operators(cfg, dev, ingest == "fold", split)
        in_bytes = audio.nbytes * (2 if ingest == "emphasized" else 1)
        nbytes = in_bytes + out_bytes + sum(t.nbytes for t in ops)
        b = dense_bound(nbytes, frames_n, cfg, band, ingest == "fold")
        print(f"K8 {key} bound: {nbytes} bytes, {b[2]:.4e} FP64 DFT "
              f"operations -> {b[0]:.4f} ms ({b[1]})")
        k8_entries.append(kernel_entry(
            f"dense DFT {key} (K8, {ingest}, split={split})",
            "mfcc_tpu_torch/csrc/dense_dft.cu", replaces, k8_launches[key],
            errs[key], times[key], times[key + " plain"], b[:2], gemm_ms))

    # -- K9, K3-v1 and K10 vs their plain versions ---------------------------------
    rng = np.random.default_rng(8)
    int_inputs = [
        ("tonal int16, S=64 x 1 s", MFCCConfig(),
         make_audio(64, 16000, seed=3).astype(np.int16)),
        ("full-range int16", MFCCConfig(),
         rng.integers(-32768, 32768, (16, 16000)).astype(np.int16)),
        ("int32 outside int16 range", MFCCConfig(),
         rng.integers(-2 ** 31, 2 ** 31, (4, 4000)).astype(np.int32)),
        ("nfilters=16", MFCCConfig(nfilters=16, nceptrums=16),
         make_audio(8, 16000, seed=4).astype(np.int16)),
        ("hop 160", MFCCConfig(step=160),
         make_audio(8, 16000, seed=5).astype(np.int16)),
    ]
    for what, icfg, x in int_inputs:
        xt = torch.from_numpy(x).to(dev)
        k2 = int_fused.mfcc_int_fused(xt, icfg)
        for kname, kern, plain in (
                ("K9", int_fused.mfcc_int_v2, int_fused.mfcc_int_fused_plain),
                ("K3-v1", int_fused.mfcc_int_v1, int_fused.mfcc_int_v1_plain),
                ("K10", int_fused.mfcc_int_split2,
                 int_fused.mfcc_int_split2_plain)):
            got = kern(xt, icfg)
            torch.cuda.synchronize()
            compare_exact(got, plain(xt, icfg), f"{kname} {what}")
            if kname != "K3-v1" or x.dtype == np.int16:
                compare_exact(got, k2, f"{kname} {what} vs K2")
        if x.dtype == np.int32:
            ref = np.stack([int_ref.mfcc_int(s_.astype(np.int64), icfg)
                            for s_ in x])
            check(np.array_equal(int_fused.mfcc_int_v1(xt, icfg).cpu().numpy(),
                                 ref), "K3-v1 on int32 differs from int_ref")
            check(not torch.equal(int_fused.mfcc_int_v1(xt, icfg), k2),
                  "K3-v1 on int32 outside int16 range equals K2")
        print(f"K9, K3-v1, K10 vs plain, {what} {tuple(xt.shape)} {xt.dtype}: "
              "equal" + (", K3-v1 equal to int_ref (K2's wire rule differs)"
                         if x.dtype == np.int32 else ", and equal to K2"))

    # -- K9, K3-v1 and K10 at the headline: launches, K2, the oracle -----------------
    zero_counts(*mods)
    k2 = int_fused.mfcc_int_fused(audio, cfg)
    int_launches = {}
    outs = {}
    for kname, keys, kern in (("K9", ("K9",), int_fused.mfcc_int_v2),
                              ("K3-v1", ("K3-v1",), int_fused.mfcc_int_v1),
                              ("K10", ("K10-front", "K10-epi"),
                               int_fused.mfcc_int_split2)):
        zero_counts(*mods)
        outs[kname] = kern(audio, cfg)
        torch.cuda.synchronize()
        n = dict(int_fused.LAUNCHES)
        check(all(n[k] == 1 for k in keys) and sum(n.values()) == len(keys)
              and fladder.LAUNCHES == 0, f"{kname} launches {n}")
        int_launches.update({k: n[k] for k in keys})
        compare_exact(outs[kname], k2, f"{kname} at the headline vs K2")
    want_i = np.stack([int_ref.mfcc_int(sig[i].astype(np.int16), cfg)
                       for i in spread])
    for kname, o in outs.items():
        ndiff = int((o[spread].cpu().numpy() != want_i).sum())
        check(ndiff == 0, f"{kname} differs from int_ref in {ndiff}")
    hpower = int_fused.mfcc_int_front(audio, cfg)
    compare_exact(hpower, int_fused.mfcc_int_front_plain(audio, cfg),
                  "K10-front at the headline")
    compare_exact(int_fused.mfcc_int_epi(hpower, cfg),
                  int_fused.mfcc_int_epi_plain(hpower, cfg),
                  "K10-epi at the headline")
    print(f"MFCC int entries on {tuple(audio.shape)} int16: K9, K3-v1 and "
          f"K10 equal to K2 and to int_ref on 8 spread streams; launches "
          f"{int_launches}; K10's power rows {tuple(hpower.shape)}")
    del outs

    # -- K9, K3-v1 and K10 times and bounds ----------------------------------------
    it = {}
    for name, fn in (
            ("K2", lambda: int_fused.mfcc_int_fused(audio, cfg)),
            ("K9", lambda: int_fused.mfcc_int_v2(audio, cfg)),
            ("K9 plain", lambda: int_fused.mfcc_int_fused_plain(audio, cfg)),
            ("K3-v1", lambda: int_fused.mfcc_int_v1(audio, cfg)),
            ("K3-v1 plain", lambda: int_fused.mfcc_int_v1_plain(audio, cfg)),
            ("K10", lambda: int_fused.mfcc_int_split2(audio, cfg)),
            ("K10-front", lambda: int_fused.mfcc_int_front(audio, cfg)),
            ("K10-front plain",
             lambda: int_fused.mfcc_int_front_plain(audio, cfg)),
            ("K10-epi", lambda: int_fused.mfcc_int_epi(hpower, cfg)),
            ("K10-epi plain",
             lambda: int_fused.mfcc_int_epi_plain(hpower, cfg))):
        it[name] = time_ms(fn)
        print(f"time {name}: {it[name]:.4f} ms, "
              f"{frames_n / it[name] * 1e3:.4e} frames/s (S={S_MAIN} x "
              f"T={T_MAIN}, {frames_n} frames, median of {ITERS}; {card})")
    ops = int_fused.int_operators(cfg, dev)
    tables = sum(t.nbytes for t in ops[:5])
    iband = ops.band.cpu()
    per_frame = int_ops_per_frame(cfg, iband)
    front_ops, epi_ops = int_ops_split(cfg, iband)
    frames_bytes = frames_n * 512 * 4
    k9_b = bound(audio.nbytes + out_bytes + tables,
                 4 * S_MAIN * T_MAIN + frames_n * per_frame, INT32_OPS)
    v1_b = bound(frames_bytes + out_bytes + tables, frames_n * per_frame,
                 INT32_OPS)
    front_b = bound(audio.nbytes + hpower.nbytes + tables,
                    4 * S_MAIN * T_MAIN + frames_n * front_ops, INT32_OPS)
    epi_b = bound(hpower.nbytes + out_bytes + tables, frames_n * epi_ops,
                  INT32_OPS)
    print(f"bounds: K9 {k9_b[0]:.4f} ms ({k9_b[1]}); K3-v1 (its kernel, on "
          f"the {frames_bytes} bytes of frames) {v1_b[0]:.4f} ms ({v1_b[1]}); "
          f"K10-front {front_b[0]:.4f} ms ({front_b[1]}, {front_ops} int32 "
          f"operations a frame), K10-epi {epi_b[0]:.4f} ms ({epi_b[1]}, "
          f"{epi_ops}); K2's per frame {per_frame}")
    del hpower
    src = "mfcc_tpu_torch/csrc/"
    return k8_entries + [
        kernel_entry("int v2 on K2's kernel (K9)", src + "int_mfcc.cu",
                     "mfcc_tpu/ops/pallas_int.py:917", int_launches["K9"], 0,
                     it["K9"], it["K9 plain"], k9_b),
        kernel_entry("int v1 on K3's kernel (K3-v1)", src + "int_mfcc.cu",
                     "mfcc_tpu/ops/pallas_int.py:1291",
                     int_launches["K3-v1"], 0, it["K3-v1"],
                     it["K3-v1 plain"], v1_b),
        kernel_entry("int split2 front (K10-front)", src + "int_split2.cu",
                     "tools/ab_int_r5.py:135", int_launches["K10-front"], 0,
                     it["K10-front"], it["K10-front plain"], front_b),
        kernel_entry("int split2 epilogue (K10-epi)", src + "int_split2.cu",
                     "tools/ab_int_r5.py:159", int_launches["K10-epi"], 0,
                     it["K10-epi"], it["K10-epi plain"], epi_b),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA card "
                         "(torch.cuda.is_available() is false)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from mfcc_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")

    kernels = [float_phases(dev, card)]
    torch.cuda.empty_cache()
    kernels += int_phases(dev, card)
    torch.cuda.empty_cache()
    kernels += serving_phases(dev, card)
    torch.cuda.empty_cache()
    kernels += fast_phases(dev, card)
    torch.cuda.empty_cache()
    kernels += f64ish_phases(dev, card)
    torch.cuda.empty_cache()
    kernels += legacy_phases(dev, card)

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
