"""K1: the fused float MFCC kernel of the float batch path.

The counterpart of ``mfcc_tpu.ops.pallas_fladder`` (the radix-2 ladder
kernel): (S, T) int16 or f32 audio -> (S, F, nceptrums) f32, with
pre-emphasis, framing, window * 1/nfft, an FFT, power on bins [0, nfft/2),
the mel product, an optional ``mel_floor``, log2 and the DCT product in one
CUDA kernel (``csrc/fladder.cu``).

``mfcc_float_ladder`` is the wrapper: a CUDA tensor launches the kernel (or
the wrapper raises), a CPU tensor takes ``mfcc_float_ladder_plain``, the
same function as a chain of torch ops.  ``LAUNCHES`` counts kernel
launches.

Both compute the interior in float64 and round to f32 once, at the output
(the TPU kernel stays in f32 because the TPU has no f64).  An f32 FFT
resolves a frame's quiet low mel bands only to ~1e-7 of its energy, and
log2 amplifies that to within 1.5x of the 5e-4 gate on long inputs; see
the note in ``csrc/fladder.cu``.  The operators are therefore float64, in natural bin
order; the Pallas kernel's sigma/regroup permutations are a TPU layout and
are not carried over.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import MFCCConfig
from .. import tables
from ..kernels import build
from . import framing

LAUNCHES = 0     # kernel launches by mfcc_float_ladder (never the plain path)


class LadderOperators(NamedTuple):
    """K1's operators on one device."""
    window: torch.Tensor   # (nfft,) float64 Hamming window * (1/nfft)
    mel: torch.Tensor      # (nfft/2, nfilters) float64, Nyquist row dropped
    dct: torch.Tensor      # (nfilters, nceptrums) float64
    band: torch.Tensor     # (nfilters, 2) int32 mel_bands(mel)


@functools.lru_cache(maxsize=None)
def nyquist_mel_row_zero(cfg: MFCCConfig) -> bool:
    """Whether bin nfft/2 carries no mel weight, so that dropping it (as
    the fused kernels do) changes nothing."""
    mel64 = tables.float_mel_matrix(cfg.samplerate, cfg.nfft, cfg.nfilters)
    return not mel64[cfg.nfft // 2].any()


def fladder_config_ok(cfg: MFCCConfig) -> bool:
    """K1's config family, the same predicate as
    ``mfcc_tpu.ops.pallas_fladder.pallas_fladder_config_ok``: nfft in
    {256, 512, 1024}, even hop, full-length windows, and a zero Nyquist mel
    row (the kernel computes bins [0, nfft/2) only)."""
    return (cfg.nfft in (256, 512, 1024) and cfg.hop % 2 == 0
            and cfg.windowlen == cfg.nfft and nyquist_mel_row_zero(cfg))


def fladder_operators(cfg: MFCCConfig) -> tuple[np.ndarray, ...]:
    """(window/nfft, mel without the Nyquist row, dct) as float64 arrays."""
    if not nyquist_mel_row_zero(cfg):
        raise ValueError("K1 needs a zero Nyquist mel row")
    win = tables.float_window(cfg.nfft) / cfg.nfft
    mel = tables.float_mel_matrix(cfg.samplerate, cfg.nfft, cfg.nfilters)
    dct = tables.dct2_ortho_matrix(cfg.nfilters)[:, : cfg.nceptrums]
    return (win, np.ascontiguousarray(mel[: cfg.nfft // 2]),
            np.ascontiguousarray(dct))


@functools.lru_cache(maxsize=None)
def default_operators(cfg: MFCCConfig, device: torch.device
                      ) -> LadderOperators:
    """``fladder_operators(cfg)`` and the mel band limits as tensors,
    cached per (cfg, device)."""
    win, mel, dct = (torch.as_tensor(a, device=device)
                     for a in fladder_operators(cfg))
    return LadderOperators(win, mel, dct, mel_bands(mel))


@functools.lru_cache(maxsize=None)
def twiddles(nfft: int, device: torch.device) -> torch.Tensor:
    """(nfft/2, 2) float64 [Re, Im] of exp(-2*pi*i*k/nfft)."""
    ang = 2.0 * np.pi * np.arange(nfft // 2) / nfft
    return torch.as_tensor(np.stack([np.cos(ang), -np.sin(ang)], axis=1),
                           device=device)


def mel_bands(mel: torch.Tensor) -> torch.Tensor:
    """(nfilters, 2) int32 [lo, hi): each mel column is zero outside rows
    [lo, hi), so the kernel sums only there (same sum as the dense product:
    the skipped terms are exact zeros).  An all-zero column gives the whole
    range.  Computed on ``mel``'s device without a host sync."""
    nz = (mel != 0).to(torch.int32)
    lo = nz.argmax(dim=0)
    hi = mel.shape[0] - nz.flip(0).argmax(dim=0)
    return torch.stack([lo, hi], dim=1).to(torch.int32).contiguous()


def _resolve(operators, cfg, device) -> LadderOperators:
    if operators is None:
        return default_operators(cfg, device)
    return operators


def check_operators(ops: LadderOperators, cfg: MFCCConfig,
                    device: torch.device, what: str) -> None:
    """Raise unless the operators are the contiguous float64 (int32 band)
    tensors of ``cfg``'s shapes on ``device`` that the kernels read."""
    nbins, nfilters, ncep = cfg.nfft // 2, cfg.nfilters, cfg.nceptrums
    for name, t, shape, dtype in (
            ("window", ops.window, (cfg.nfft,), torch.float64),
            ("mel", ops.mel, (nbins, nfilters), torch.float64),
            ("dct", ops.dct, (nfilters, ncep), torch.float64),
            ("band", ops.band, (nfilters, 2), torch.int32)):
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{what} operator {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {device}")


def ladder_tail_plain(frames64: torch.Tensor, ops: LadderOperators,
                      cfg: MFCCConfig, mel_floor: float = 0.0
                      ) -> torch.Tensor:
    """The kernels' tail as plain torch ops, on (..., F, nfft) float64
    pre-emphasized frames: window * 1/nfft, FFT, power on bins [0, nfft/2),
    mel, optional floor, log2, DCT; rounded to f32 once.  Shared by K1's
    and K4-float's plain versions."""
    spec = torch.fft.rfft(frames64 * ops.window, dim=-1)[..., : cfg.nfft // 2]
    power = spec.real * spec.real + spec.imag * spec.imag
    melspec = power @ ops.mel
    if mel_floor:
        melspec = torch.clamp_min(melspec, mel_floor)
    return (torch.log2(melspec) @ ops.dct).to(torch.float32)


def mfcc_float_ladder_plain(audio: torch.Tensor,
                            cfg: MFCCConfig = MFCCConfig(),
                            mel_floor: float = 0.0,
                            operators: LadderOperators | None = None
                            ) -> torch.Tensor:
    """K1 as plain torch ops: (..., T) -> (..., F, nceptrums) f32,
    computed in float64 from any input dtype (never truncated to int16)."""
    ops = _resolve(operators, cfg, audio.device)
    emph = framing.preemphasis(audio.to(torch.float64))
    frames = framing.extract_frames(emph, cfg.nfft, cfg.hop)
    return ladder_tail_plain(frames, ops, cfg, mel_floor)


def mfcc_float_ladder(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(),
                      mel_floor: float = 0.0,
                      operators: LadderOperators | None = None
                      ) -> torch.Tensor:
    """K1: (..., T) int16 or f32 -> (..., F, nceptrums) f32.  On a CUDA
    tensor this launches the kernel or raises; a CPU tensor takes
    ``mfcc_float_ladder_plain``."""
    global LAUNCHES
    if not fladder_config_ok(cfg):
        raise ValueError(f"config outside K1's family: {cfg}")
    if audio.device.type == "cpu":
        return mfcc_float_ladder_plain(audio, cfg, mel_floor, operators)
    if audio.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, got {audio.device}")
    if audio.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"K1 takes int16 or float32 audio, got {audio.dtype}")
    if not audio.is_contiguous():
        raise ValueError("K1 needs contiguous audio")
    ops = _resolve(operators, cfg, audio.device)
    check_operators(ops, cfg, audio.device, "K1")
    out = launch_ladder(audio, cfg, mel_floor, ops)
    LAUNCHES += 1
    return out


def launch_ladder(audio: torch.Tensor, cfg: MFCCConfig, mel_floor: float,
                  ops: LadderOperators) -> torch.Tensor:
    """Launch ``mfcc_fladder_{i16,f32}`` on contiguous (..., T) int16 or
    f32 CUDA audio with checked operators, at ``cfg``'s hop (the kernel
    frames by address, so any hop >= 1); counts nothing.  Shared by K1 and
    K6 (``float_fused.mfcc_recomp_t``), each counting its own launches."""
    nfilters, ncep = cfg.nfilters, cfg.nceptrums
    lead, T = audio.shape[:-1], audio.shape[-1]
    n_frames = framing.num_frames(T, cfg.hop, cfg.nfft)
    x = audio.reshape(-1, T)
    S = x.shape[0]
    out = torch.empty((S, n_frames, ncep), dtype=torch.float32,
                      device=audio.device)
    tw = twiddles(cfg.nfft, audio.device)

    lib = build.library()
    fn = (lib.mfcc_fladder_i16 if audio.dtype == torch.int16
          else lib.mfcc_fladder_f32)
    build.launch(fn, audio.device, x.data_ptr(), out.data_ptr(), S, T,
                 n_frames, cfg.hop, cfg.nfft, nfilters, ncep,
                 ops.window.data_ptr(), tw.data_ptr(), ops.mel.data_ptr(),
                 ops.dct.data_ptr(), ops.band.data_ptr(), float(mel_floor))
    return out.reshape(lead + (n_frames, ncep))
