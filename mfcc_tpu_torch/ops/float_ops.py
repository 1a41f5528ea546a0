"""Float MFCC pipeline as a chain of torch ops.

The counterpart of ``mfcc_tpu.ops.float_ops``: three matmuls with
elementwise work between them --

  1. frames @ [window-weighted DFT]     (nfft x 2*nbins: re|im concatenated)
  2. power  @ mel                       (nbins x nfilters)
  3. logmel @ dct                       (nfilters x nceptrums)

``method="rfft"`` replaces step 1 with ``torch.fft.rfft`` of the windowed
frames (identical numerics spec); ``mfcc_segmented`` (``mfcc_batch``'s
``method="segmented"``) runs step 1 as shifted matmuls over hop-sized
segments of the emphasized signal.  This chain is the route of
``MFCC.frames`` and of configurations outside the fused kernel's family,
and the plain baseline that the kernels are timed against.

Precisions:

  * ``"highest"``: every matmul in full float32;
  * ``"high"``, ``"default"`` and ``"bf16"``: the TPU's bf16 matmul passes
    with f32 accumulation in the chain's three products (DFT, mel, DCT):
    3 passes for "high" (hi*hi + hi*lo + lo*hi, ``Precision.HIGH``), 1 for
    "default" and "bf16" (hi*hi; "bf16" is ``Precision.DEFAULT`` in JAX),
    on CUDA tensors; CPU tensors take full float32, which is what the JAX
    package computes off its TPU (XLA's CPU dot ignores the precision
    enum).  ``limbs=`` overrides the pass count on any device.  These are
    fidelity routes: one pass misses the 5e-4 float contract by far (the
    JAX package read 2.3e-1 on its TPU, docs/BENCH.md:19);
  * ``"split"``: the DFT as ``split_matmul`` (four f32 matmuls of
    bf16-valued limbs), mel and DCT in full float32;
  * ``"f64ish"``: the f64ish dial (``ops/f64ish.py``, K7), which ignores
    ``method``, ``dtype``, ``mel_floor`` and ``operators`` as the JAX
    package does;
  * ``power_spectrum_frames`` / ``log_mel_frames`` take "split" and
    "f64ish" as full float32 (what ``_matmul_precision`` gives them in JAX).

The ``"fast"`` dial is a kernel route (``ops/float_fused.py``), not a
precision of this chain.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import MFCCConfig
from .. import tables
from . import framing

PRECISIONS = ("highest", "high", "default", "bf16", "split", "f64ish")
# bf16 passes of each product on the card (the TPU's Precision.HIGH and
# DEFAULT); "bf16" is DEFAULT, as float_ops._matmul_precision maps it in JAX
LIMB_PASSES = {"high": 3, "default": 1, "bf16": 1}

# The 5e-4 float gate needs full-f32 matmuls.  TF32 keeps ~10 mantissa bits,
# the same class as plain bf16 matmuls, which failed this gate at 2.3e-1 in
# the JAX package's measurements (docs/BENCH.md:19).  Matmuls default to
# full f32 already; cuDNN does not, so both are pinned.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Operators(NamedTuple):
    """The chain's constant operators, as tensors of one dtype and device."""
    window: torch.Tensor   # (nfft,) periodic Hamming window
    dft: torch.Tensor      # (nfft, 2*nbins) windowed DFT [C | S], * 1/nfft
    mel: torch.Tensor      # (nbins, nfilters) triangular mel filters
    dct: torch.Tensor      # (nfilters, nceptrums) orthonormal DCT-II


def operators_np(cfg: MFCCConfig, window: np.ndarray | None = None,
                 mel: np.ndarray | None = None,
                 dct: np.ndarray | None = None) -> dict:
    """The operators in float64 numpy, from ``tables`` unless given.
    The DFT operator is built from the (given or default) window."""
    if window is None:
        window = tables.float_window(cfg.nfft)
    if mel is None:
        mel = tables.float_mel_matrix(cfg.samplerate, cfg.nfft, cfg.nfilters)
    if dct is None:
        dct = tables.dct2_ortho_matrix(cfg.nfilters)[:, : cfg.nceptrums]
    window = np.asarray(window, np.float64)
    C, S = tables.windowed_rdft_matrix(cfg.nfft, window=window)
    ops = dict(window=window, dft=np.concatenate([C, S], axis=1), mel=mel,
               dct=dct)
    return {k: np.ascontiguousarray(v, dtype=np.float64)
            for k, v in ops.items()}


@functools.lru_cache(maxsize=None)
def default_operators(cfg: MFCCConfig, dtype: torch.dtype,
                      device: torch.device) -> Operators:
    """``Operators`` of ``cfg``'s tables, cached per (cfg, dtype, device)."""
    ops = operators_np(cfg)
    return Operators(**{k: torch.as_tensor(v, dtype=dtype, device=device)
                        for k, v in ops.items()})


def _check_precision(precision: str, ported=PRECISIONS) -> None:
    if precision not in ported:
        raise ValueError(
            f"unknown precision {precision!r} for the chain (fast is the "
            "split-DFT kernel route of MFCC and StreamingMFCC); use one of "
            f"{ported}")


def limb_passes(precision: str, device, limbs: int | None = None) -> int:
    """bf16 passes of each of the chain's products, 0 for full float32:
    ``LIMB_PASSES[precision]`` on a CUDA device and 0 on the CPU for
    "high", "default" and "bf16", unless ``limbs`` (0, 1 or 3) says
    otherwise; 0 for every other precision, which takes no ``limbs``."""
    if precision not in LIMB_PASSES:
        if limbs is not None:
            raise ValueError(f"limbs= applies to {tuple(LIMB_PASSES)}, not "
                             f"to precision={precision!r}")
        return 0
    if limbs is None:
        cpu = torch.device(device).type == "cpu"
        return 0 if cpu else LIMB_PASSES[precision]
    if limbs not in (0, 1, 3):
        raise ValueError(f"limbs={limbs!r}: 0, 1 or 3 bf16 passes")
    return limbs


def _bf16_trunc(x: torch.Tensor) -> torch.Tensor:
    """Round an f32 tensor to bf16 precision by mantissa bit arithmetic,
    nearest even, as ``float_ops._bf16_trunc`` in the JAX package (which
    avoids a cast that XLA may elide); the result is f32."""
    u = x.view(torch.int32)
    bias = 0x7FFF + ((u >> 16) & 1)
    return ((u + bias) & -0x10000).view(torch.float32)


def split_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Error-compensated bf16 matmul of f32 operands, the counterpart of
    ``float_ops.split_matmul``: x = x_hi + x_lo and w = w_hi + w_lo with
    x_hi = ``_bf16_trunc(x)`` and x_lo = bf16(x - x_hi) (likewise w), and
    hi@hi + hi@lo + lo@hi + lo@lo as four f32 matmuls of the bf16-valued
    limbs (every product exact in f32, TF32 pinned off, f32 sums):
    ~16 mantissa bits, ~1e-5 relative."""
    x_hi, w_hi = _bf16_trunc(x), _bf16_trunc(w)
    x_lo = (x - x_hi).to(torch.bfloat16).to(torch.float32)
    w_lo = (w - w_hi).to(torch.bfloat16).to(torch.float32)
    out = x_hi @ w_hi
    out = out + x_hi @ w_lo
    out = out + x_lo @ w_hi
    return out + x_lo @ w_lo


def limb_matmul(x: torch.Tensor, w: torch.Tensor,
                passes: int) -> torch.Tensor:
    """The TPU's bf16 matmul passes with f32 accumulation: hi*hi (1 pass)
    or hi*hi + hi*lo + lo*hi (3 passes, ``Precision.HIGH``), with x_hi =
    ``_bf16_trunc(x)`` and x_lo = ``_bf16_trunc(x - x_hi)`` (likewise w),
    multiplied as f32 tensors (TF32 pinned off): a product of two
    bf16-exact values is exact in f32, so each pass is the MXU's bf16 pass.
    Not a matmul of bf16 tensors, whose output torch rounds to bf16.
    Operands of another dtype multiply as they are."""
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        return x @ w
    x_hi, w_hi = _bf16_trunc(x), _bf16_trunc(w)
    out = x_hi @ w_hi
    if passes == 3:
        out = out + x_hi @ _bf16_trunc(w - w_hi)
        out = out + _bf16_trunc(x - x_hi) @ w_hi
    return out


def _matmul(passes: int):
    """The chain's product at ``passes`` bf16 passes (0: full float32)."""
    if passes:
        return functools.partial(limb_matmul, passes=passes)
    return torch.matmul


def _resolve(operators, cfg, dtype, device) -> Operators:
    if operators is None:
        return default_operators(cfg, dtype, torch.device(device))
    return operators


def mfcc_frames(frames: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
                method: str = "dft", precision: str = "highest",
                dtype: torch.dtype = torch.float32, mel_floor: float = 0.0,
                operators: Operators | None = None,
                limbs: int | None = None) -> torch.Tensor:
    """MFCC of pre-emphasized frames: (..., F, nfft) -> (..., F, nceptrums).

    method='dft'  -- windowed-DFT matmul (``split_matmul`` under "split").
    method='rfft' -- torch.fft.rfft path (identical numerics spec).
    ``limbs``: the bf16 passes of "high", "default" and "bf16" (see
    ``limb_passes``).
    """
    _check_precision(precision)
    if precision == "f64ish":
        from . import f64ish
        return f64ish.mfcc_frames_f64ish(frames, cfg)
    frames = frames.to(dtype)
    mm = _matmul(limb_passes(precision, frames.device, limbs))
    ops = _resolve(operators, cfg, dtype, frames.device)
    if method == "dft":
        dft_mm = split_matmul if precision == "split" else mm
        power = _dft_power(frames, ops, cfg.nbins_float, dft_mm)
    elif method == "rfft":
        spec = torch.fft.rfft(frames * ops.window, dim=-1) / cfg.nfft
        power = spec.abs().to(dtype) ** 2
    else:
        raise ValueError(f"unknown method {method!r}")
    return _log_mel_dct(power, ops, mel_floor, mm)


def mfcc_batch(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
               method: str = "dft", precision: str = "highest",
               dtype: torch.dtype = torch.float32, mel_floor: float = 0.0,
               operators: Operators | None = None,
               limbs: int | None = None) -> torch.Tensor:
    """Full float pipeline on raw signals: (..., T) -> (..., F, nceptrums).
    ``method="segmented"`` runs ``mfcc_segmented`` (``"dft"`` when
    windowlen != nfft, whose frames the segment layout cannot hold)."""
    _check_precision(precision)
    if precision == "f64ish":
        from . import f64ish
        return f64ish.mfcc_batch_f64ish(audio, cfg)
    emph = framing.preemphasis(audio.to(dtype))
    if method == "segmented":
        if cfg.windowlen == cfg.nfft:
            return mfcc_segmented(emph, cfg, precision=precision,
                                  dtype=dtype, mel_floor=mel_floor,
                                  operators=operators, limbs=limbs)
        method = "dft"
    frames = framing.extract_frames(emph, cfg.nfft, cfg.hop,
                                    windowlen=cfg.windowlen)
    return mfcc_frames(frames, cfg, method=method, precision=precision,
                       dtype=dtype, mel_floor=mel_floor, operators=operators,
                       limbs=limbs)


def mfcc_segmented(audio_emph: torch.Tensor, cfg: MFCCConfig = MFCCConfig(),
                   *, precision: str = "highest",
                   dtype: torch.dtype = torch.float32, mel_floor: float = 0.0,
                   operators: Operators | None = None,
                   limbs: int | None = None) -> torch.Tensor:
    """Float pipeline on EMPHASIZED audio via segment matmuls: (..., T) ->
    (..., F, nceptrums), the counterpart of ``float_ops.mfcc_segmented``.
    The windowed-DFT operator is split along the frame axis into hop-sized
    segments (frame i = segments i .. i+nseg-1 and the first nfft % hop
    samples of segment i+nseg), so the DFT is a sum of shifted matmuls over
    the (L, hop) reshape of the signal: no frame is materialized.  The same
    numerics spec as ``mfcc_frames(method="dft")``, at any precision but
    "f64ish" (under "split" the segment matmuls are ``split_matmul``)."""
    _check_precision(precision, tuple(p for p in PRECISIONS
                                      if p != "f64ish"))
    x = audio_emph.to(dtype)
    T = x.shape[-1]
    hop, nfft = cfg.hop, cfg.nfft
    n = cfg.n_frames(T)
    ops = _resolve(operators, cfg, dtype, x.device)
    nseg, rem = nfft // hop, nfft % hop
    L = n + nseg + (1 if rem else 0)           # segment rows needed
    need = L * hop
    if need > T:
        x = torch.nn.functional.pad(x, (0, need - T))
    X = x[..., :need].reshape(x.shape[:-1] + (L, hop))
    mm = _matmul(limb_passes(precision, x.device, limbs))
    seg_mm = split_matmul if precision == "split" else mm
    reim = None
    for q in range(nseg):
        t = seg_mm(X[..., q: q + n, :], ops.dft[q * hop: (q + 1) * hop])
        reim = t if reim is None else reim + t
    if rem:
        reim = reim + seg_mm(X[..., nseg: nseg + n, :rem],
                             ops.dft[nseg * hop:])
    nbins = cfg.nbins_float
    re, im = reim[..., :nbins], reim[..., nbins:]
    return _log_mel_dct(re * re + im * im, ops, mel_floor, mm)


# -- Partial feature extractors (the model-family surface) -------------------

def power_spectrum_frames(frames: torch.Tensor,
                          cfg: MFCCConfig = MFCCConfig(), *,
                          precision: str = "highest",
                          dtype: torch.dtype = torch.float32,
                          operators: Operators | None = None,
                          limbs: int | None = None) -> torch.Tensor:
    """(..., F, nfft) -> (..., F, nbins_float) |fft(w*x)/nfft|^2."""
    _check_precision(precision)
    frames = frames.to(dtype)
    ops = _resolve(operators, cfg, dtype, frames.device)
    mm = _matmul(limb_passes(precision, frames.device, limbs))
    return _dft_power(frames, ops, cfg.nbins_float, mm)


def log_mel_frames(frames: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
                   precision: str = "highest",
                   dtype: torch.dtype = torch.float32, mel_floor: float = 0.0,
                   operators: Operators | None = None,
                   limbs: int | None = None) -> torch.Tensor:
    """(..., F, nfft) -> (..., F, nfilters) log2 mel energies."""
    power = power_spectrum_frames(frames, cfg, precision=precision,
                                  dtype=dtype, operators=operators,
                                  limbs=limbs)
    ops = _resolve(operators, cfg, dtype, power.device)
    mm = _matmul(limb_passes(precision, power.device, limbs))
    return _log_mel(power, ops, mel_floor, mm)


def mel_product(power: torch.Tensor, mel: torch.Tensor, precision: str,
                limbs: int | None = None) -> torch.Tensor:
    """``power @ mel`` at ``precision``'s passes on ``power``'s device (the
    mel spectrogram's product)."""
    return _matmul(limb_passes(precision, power.device, limbs))(power, mel)


def _dft_power(frames, ops: Operators, nbins: int,
               mm=torch.matmul) -> torch.Tensor:
    reim = mm(frames, ops.dft)
    re, im = reim[..., :nbins], reim[..., nbins:]
    return re * re + im * im


def _log_mel(power, ops: Operators, mel_floor: float,
             mm=torch.matmul) -> torch.Tensor:
    melspec = mm(power, ops.mel)
    if mel_floor:
        melspec = torch.clamp_min(melspec, mel_floor)
    return torch.log2(melspec)


def _log_mel_dct(power, ops: Operators, mel_floor: float,
                 mm=torch.matmul) -> torch.Tensor:
    return mm(_log_mel(power, ops, mel_floor, mm), ops.dct)
