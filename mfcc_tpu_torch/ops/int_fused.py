"""K2 and K3: the fused bit-exact INT MFCC kernels of the INT batch path.

The counterpart of ``mfcc_tpu.ops.pallas_int``:

  * ``mfcc_int_fused`` (K2, the counterpart of ``mfcc_int_pallas_v3``):
    (..., T) int16-range audio -> (..., F, nceptrums) int32, with
    pre-emphasis, framing, the window, the 512-point INT FFT, power, the
    integer filterbank, log2 and the INT DCT in one CUDA kernel;
  * ``mfcc_int_fused_frames`` (K3, the counterpart of
    ``mfcc_int_pallas_frames``): (..., F, 512) int32 pre-emphasized frames
    -> (..., F, nceptrums) int32, the same kernel body from the window on.

Both are ``csrc/int_mfcc.cu`` on the device functions of
``csrc/int_stages.cuh``.  A CUDA tensor launches the kernel (or the wrapper
raises), a CPU tensor takes the plain version: ``mfcc_int_fused_plain`` and
``mfcc_int_fused_frames_plain``, the ``int_ops`` chain.  ``LAUNCHES``
counts kernel launches.

K2 reads samples as int16, the JAX kernel's wire contract
(``pallas_int.py:1097``): int32 input is taken mod 2^16 first, by the
kernel's wrapper and by its plain version alike, so the two agree on any
input.  The results are element-exact with ``ref.int_ref.mfcc_int``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import MFCCConfig
from .. import tables
from ..kernels import build
from . import framing, int_ops
from .fladder import mel_bands

LAUNCHES = 0     # kernel launches by mfcc_int_fused[_frames] (never the plain)


def int_config_ok(cfg: MFCCConfig) -> bool:
    """The fused kernels' config family, the same predicate as
    ``mfcc_tpu.ops.pallas_int.pallas_int_config_ok``: the reference 16-bit
    datapath at nfft 512, even hop, 16 or 32 filters, full-length
    windows."""
    return (cfg.nfft == 512 and cfg.hop % 2 == 0
            and cfg.nfilters in (16, 32) and cfg.width == 16
            and cfg.window_precision == 8 and cfg.power_width == 30
            and cfg.windowlen == cfg.nfft
            and int_ops._fb_int32_layout_ok(cfg))


class IntOperators(NamedTuple):
    """The kernels' constant tables on one device (the RTL's ROMs)."""
    curve: torch.Tensor    # (512,) int32 window curve
    tw: torch.Tensor       # (256, 2) int32 (re, im) twiddles, 512 points
    dtw: torch.Tensor      # (2*nfilters, 2) int32 twiddles, 4*nfilters points
    fbw: torch.Tensor      # (256, nfilters) int64 filterbank matrix
    band: torch.Tensor     # (nfilters, 2) int32 [lo, hi) nonzero rows of fbw
    fb_shift: int          # the filterbank keeps bits [shift, shift+16)


def _twiddles(size: int) -> np.ndarray:
    return np.stack(tables.twiddle_table(size, 16), axis=1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def int_operators(cfg: MFCCConfig, device: torch.device) -> IntOperators:
    """The tables of ``cfg`` as tensors on ``device``, cached per
    (cfg, device)."""
    W, shift = int_ops._fb_constants(cfg.samplerate, cfg.nfft, cfg.nfilters,
                                     cfg.filter_wsize, cfg.filter_gain, 16,
                                     cfg.power_width)
    curve, tw, dtw, fbw = (torch.as_tensor(a, device=device) for a in (
        tables.int_window_curve(cfg.nfft, cfg.window_precision)
        .astype(np.int32), _twiddles(cfg.nfft), _twiddles(4 * cfg.nfilters),
        W))
    return IntOperators(curve, tw, dtw, fbw, mel_bands(fbw), shift)


def _check(x: torch.Tensor, dtypes, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{what} takes {' or '.join(map(str, dtypes))} "
                        f"input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} needs contiguous input")


def _launch(fn, x: torch.Tensor, *args) -> None:
    global LAUNCHES
    build.launch(fn, x.device, *args)
    LAUNCHES += 1


def tail_args(cfg: MFCCConfig, ops: IntOperators) -> tuple:
    """(nfilters, ncep, fb_shift, log_precision, log_width)."""
    return (cfg.nfilters, min(cfg.nceptrums, cfg.nfilters), ops.fb_shift,
            cfg.log_precision, cfg.log_width_output)


def table_ptrs(ops: IntOperators) -> tuple:
    return (ops.curve.data_ptr(), ops.tw.data_ptr(), ops.dtw.data_ptr(),
            ops.fbw.data_ptr(), ops.band.data_ptr())


def _require_family(cfg: MFCCConfig) -> None:
    if not int_config_ok(cfg):
        raise ValueError(f"config outside the fused INT kernels' family: {cfg}")


def mfcc_int_fused_plain(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                         ) -> torch.Tensor:
    """K2 as plain torch ops: samples mod 2^16 (the int16 wire contract),
    then the ``int_ops`` chain.  (..., T) -> (..., F, nceptrums) int32."""
    return int_ops.mfcc_int_batch(
        framing.wrap_signed(audio.to(torch.int32), 16), cfg)


def mfcc_int_fused_frames_plain(frames: torch.Tensor,
                                cfg: MFCCConfig = MFCCConfig()
                                ) -> torch.Tensor:
    """K3 as plain torch ops: the ``int_ops`` chain on the frames."""
    return int_ops.mfcc_int_frames(frames, cfg)


def mfcc_int_fused(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                   ) -> torch.Tensor:
    """K2: (..., T) int16 or int32 audio -> (..., F, nceptrums) int32.  On
    a CUDA tensor this launches the kernel (int32 samples are taken mod
    2^16 first) or raises; a CPU tensor takes ``mfcc_int_fused_plain``."""
    _require_family(cfg)
    if audio.device.type == "cpu":
        return mfcc_int_fused_plain(audio, cfg)
    _check(audio, (torch.int16, torch.int32), "K2")
    lead, T = audio.shape[:-1], audio.shape[-1]
    F = framing.num_frames(T, cfg.hop, cfg.nfft)
    x = audio.reshape(-1, T)
    if x.dtype != torch.int16:
        x = framing.wrap_signed(x, 16).to(torch.int16)
    S = x.shape[0]
    ops = int_operators(cfg, audio.device)
    tail = tail_args(cfg, ops)
    out = torch.empty((S, F, tail[1]), dtype=torch.int32, device=audio.device)
    _launch(build.library().mfcc_int_i16, audio, x.data_ptr(),
            out.data_ptr(), S, T, F, cfg.hop, *tail, *table_ptrs(ops))
    return out.reshape(lead + (F, tail[1]))


def mfcc_int_fused_frames(frames: torch.Tensor,
                          cfg: MFCCConfig = MFCCConfig()) -> torch.Tensor:
    """K3: (..., F, 512) int32 pre-emphasized frames -> (..., F, nceptrums)
    int32.  On a CUDA tensor this launches the kernel or raises; a CPU
    tensor takes ``mfcc_int_fused_frames_plain``."""
    _require_family(cfg)
    if frames.device.type == "cpu":
        return mfcc_int_fused_frames_plain(frames, cfg)
    _check(frames, (torch.int32,), "K3")
    if frames.dim() < 2 or frames.shape[-1] != cfg.nfft:
        raise ValueError(f"K3 takes (..., F, {cfg.nfft}) frames, got "
                         f"{tuple(frames.shape)}")
    lead = frames.shape[:-1]
    M = frames.numel() // cfg.nfft
    ops = int_operators(cfg, frames.device)
    tail = tail_args(cfg, ops)
    out = torch.empty((M, tail[1]), dtype=torch.int32, device=frames.device)
    _launch(build.library().mfcc_int_frames_i32, frames, frames.data_ptr(),
            out.data_ptr(), M, *tail, *table_ptrs(ops))
    return out.reshape(lead + (tail[1],))
