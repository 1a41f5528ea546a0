"""Float MFCC pipeline as a chain of torch ops.

The counterpart of ``mfcc_tpu.ops.float_ops``: three matmuls with
elementwise work between them --

  1. frames @ [window-weighted DFT]     (nfft x 2*nbins: re|im concatenated)
  2. power  @ mel                       (nbins x nfilters)
  3. logmel @ dct                       (nfilters x nceptrums)

``method="rfft"`` replaces step 1 with ``torch.fft.rfft`` of the windowed
frames (identical numerics spec).  This chain is the route of
``MFCC.frames`` and of configurations outside the fused kernel's family,
and the plain baseline that the kernels are timed against.

Only ``precision="highest"`` is ported here: the matmuls run in full
float32.  The ``"fast"`` dial is a kernel route (``ops/float_fused.py``),
not a precision of this chain.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import MFCCConfig
from .. import tables
from . import framing

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


def _check_precision(precision: str) -> None:
    if precision != "highest":
        raise NotImplementedError(
            f"precision={precision!r} is not ported to the torch package's "
            "chain yet (split, f64ish, high, default and bf16 wait for a "
            "later slice of the port; fast is the split-DFT kernel route of "
            "MFCC and StreamingMFCC); use precision='highest'")


def _resolve(operators, cfg, dtype, device) -> Operators:
    if operators is None:
        return default_operators(cfg, dtype, torch.device(device))
    return operators


def mfcc_frames(frames: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
                method: str = "dft", precision: str = "highest",
                dtype: torch.dtype = torch.float32, mel_floor: float = 0.0,
                operators: Operators | None = None) -> torch.Tensor:
    """MFCC of pre-emphasized frames: (..., F, nfft) -> (..., F, nceptrums).

    method='dft'  -- windowed-DFT matmul.
    method='rfft' -- torch.fft.rfft path (identical numerics spec).
    """
    _check_precision(precision)
    frames = frames.to(dtype)
    ops = _resolve(operators, cfg, dtype, frames.device)
    if method == "dft":
        power = _dft_power(frames, ops, cfg.nbins_float)
    elif method == "rfft":
        spec = torch.fft.rfft(frames * ops.window, dim=-1) / cfg.nfft
        power = spec.abs().to(dtype) ** 2
    else:
        raise ValueError(f"unknown method {method!r}")
    return _log_mel_dct(power, ops, mel_floor)


def mfcc_batch(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
               method: str = "dft", precision: str = "highest",
               dtype: torch.dtype = torch.float32, mel_floor: float = 0.0,
               operators: Operators | None = None) -> torch.Tensor:
    """Full float pipeline on raw signals: (..., T) -> (..., F, nceptrums)."""
    _check_precision(precision)
    emph = framing.preemphasis(audio.to(dtype))
    frames = framing.extract_frames(emph, cfg.nfft, cfg.hop,
                                    windowlen=cfg.windowlen)
    return mfcc_frames(frames, cfg, method=method, precision=precision,
                       dtype=dtype, mel_floor=mel_floor, operators=operators)


# -- Partial feature extractors (the model-family surface) -------------------

def power_spectrum_frames(frames: torch.Tensor,
                          cfg: MFCCConfig = MFCCConfig(), *,
                          precision: str = "highest",
                          dtype: torch.dtype = torch.float32,
                          operators: Operators | None = None) -> torch.Tensor:
    """(..., F, nfft) -> (..., F, nbins_float) |fft(w*x)/nfft|^2."""
    _check_precision(precision)
    frames = frames.to(dtype)
    ops = _resolve(operators, cfg, dtype, frames.device)
    return _dft_power(frames, ops, cfg.nbins_float)


def log_mel_frames(frames: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
                   precision: str = "highest",
                   dtype: torch.dtype = torch.float32, mel_floor: float = 0.0,
                   operators: Operators | None = None) -> torch.Tensor:
    """(..., F, nfft) -> (..., F, nfilters) log2 mel energies."""
    power = power_spectrum_frames(frames, cfg, precision=precision,
                                  dtype=dtype, operators=operators)
    ops = _resolve(operators, cfg, dtype, power.device)
    return _log_mel(power, ops, mel_floor)


def _dft_power(frames, ops: Operators, nbins: int) -> torch.Tensor:
    reim = frames @ ops.dft
    re, im = reim[..., :nbins], reim[..., nbins:]
    return re * re + im * im


def _log_mel(power, ops: Operators, mel_floor: float) -> torch.Tensor:
    melspec = power @ ops.mel
    if mel_floor:
        melspec = torch.clamp_min(melspec, mel_floor)
    return torch.log2(melspec)


def _log_mel_dct(power, ops: Operators, mel_floor: float) -> torch.Tensor:
    return _log_mel(power, ops, mel_floor) @ ops.dct
