"""Drive the torch port's float batch path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA card (the kernels
target sm_90a, Hopper), nvcc and PyTorch built for CUDA.  It

  1. prints the card (``nvidia-smi``), torch's and CUDA's versions;
  2. builds the CUDA kernels from ``mfcc_tpu_torch/csrc`` and prints the
     seconds taken;
  3. compares each kernel with its plain torch version on the card: K1
     (``ops/fladder.py``) at nfft 256/86, 512/170 and 1024/340 on int16,
     f32, normalized [-1, 1] f32 and silent (``mel_floor=1.0``) input, and
     at the headline shape, within ``KERNEL_TOL``;
  4. drives ``MFCC()`` on S=1024 streams x 4 s of int16 audio, checks that
     K1 launched once per call, the shape, finiteness, and the gate against
     the float64 oracle on 8 spread streams;
  5. times K1 against its plain version and the plain ``float_ops`` chain
     (CUDA events, median of 10 after warm-up).

Any failed check raises, so the exit code is not 0.  Without a CUDA card
it exits with an error before printing anything else.  The line before the
last is a JSON summary of the kernels; the last line is the JSON result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_TOL = 5e-5   # kernel vs its plain version (both float64 inside)
GATE = 5e-4         # the float contract: max-abs vs the float64 oracle
S_MAIN, T_MAIN = 1024, 63_922   # 4 s per stream at 16 kHz: 374 frames
ITERS, WARMUP = 10, 3


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

    from mfcc_tpu_torch import MFCC, MFCCConfig
    from mfcc_tpu_torch.kernels import build
    from mfcc_tpu_torch.ops import fladder, float_ops
    from mfcc_tpu_torch.ref import float_ref

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")

    # -- 1. kernel vs plain version ----------------------------------------
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

    # -- 2. the main path ----------------------------------------------------
    cfg = MFCCConfig()
    sig = make_audio(S_MAIN, T_MAIN)
    audio = torch.from_numpy(sig.astype(np.int16)).to(dev)
    fe = MFCC().to(dev)
    calls = 2
    fladder.LAUNCHES = 0
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
    chain = float_ops.mfcc_batch(audio, cfg)
    chain_err = float(np.abs(chain[spread].cpu().numpy() - want).max())
    print(f"plain float_ops chain (f32 DFT matmul): max-abs vs oracle "
          f"{chain_err:.3e}")
    del chain

    # -- 3. times ------------------------------------------------------------
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

    summary = {"kernels": [{
        "name": "fladder (K1)", "route": "cuda",
        "source": "mfcc_tpu_torch/csrc/fladder.cu",
        "replaces": "mfcc_tpu/ops/pallas_fladder.py:215",
        "launches": launches, "max_abs_err": max(errs),
        "ms": times["K1 kernel (mfcc_float_ladder)"],
        "plain_ms": times["K1 plain version (float64 torch ops)"],
    }]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
