"""K2, K3, K9, K3-v1 and K10: the fused bit-exact INT MFCC kernels.

The counterpart of ``mfcc_tpu.ops.pallas_int`` and of the two-kernel arm
of ``tools/ab_int_r5.py``:

  * ``mfcc_int_fused`` (K2, the counterpart of ``mfcc_int_pallas_v3``):
    (..., T) int16-range audio -> (..., F, nceptrums) int32, with
    pre-emphasis, framing, the window, the 512-point INT FFT, power, the
    integer filterbank, log2 and the INT DCT in one CUDA kernel;
  * ``mfcc_int_fused_frames`` (K3, the counterpart of
    ``mfcc_int_pallas_frames``): (..., F, 512) int32 pre-emphasized frames
    -> (..., F, nceptrums) int32, the same kernel body from the window on;
  * ``mfcc_int_v2`` (K9, the counterpart of ``mfcc_int_pallas_v2``): K2's
    function under K2's wire rule, on K2's kernel;
  * ``mfcc_int_v1`` (K3-v1, the counterpart of ``mfcc_int_pallas``): int32
    samples emphasized as they are (only the emphasis output wraps to 16
    bits), framed by torch ops, then K3's kernel;
  * ``mfcc_int_split2`` (K10, the counterpart of ``split2_build``): K2's
    function in two launches, ``mfcc_int_front_i16`` up to the power and
    ``mfcc_int_epi`` after it, with a (frames, 256) int32 power buffer in
    device memory between them (``csrc/int_split2.cu``).

K2 and K3 are ``csrc/int_mfcc.cu``; every kernel runs the device functions
of ``csrc/int_stages.cuh``.  A CUDA tensor launches the kernel (or the
wrapper raises), a CPU tensor takes the plain version (``*_plain``, the
``int_ops`` chain).  ``LAUNCHES`` counts kernel launches per entry.

K2, K9 and K10 read samples as int16, the JAX kernels' wire contract
(``pallas_int.py:893``, ``:1097``): int32 input is taken mod 2^16 first, by
the wrapper and by its plain version alike, so the two agree on any input.
K3-v1 takes int32 samples whole, as ``mfcc_int_pallas`` does
(``pallas_int.py:1271``), so on int32 input outside the int16 range it
follows ``ref.int_ref.mfcc_int`` where K2 does not.  The results are
element-exact with ``ref.int_ref.mfcc_int`` on int16-range input.
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

# kernel launches per entry (never the plain versions)
LAUNCHES = {"K2": 0, "K3": 0, "K9": 0, "K3-v1": 0, "K10-front": 0,
            "K10-epi": 0}


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


def _launch(key: str, fn, x: torch.Tensor, *args) -> None:
    build.launch(fn, x.device, *args)
    LAUNCHES[key] += 1


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
    then the ``int_ops`` chain.  (..., T) -> (..., F, nceptrums) int32.
    Also K9's plain version."""
    return int_ops.mfcc_int_batch(_wire16(audio), cfg)


def mfcc_int_fused_frames_plain(frames: torch.Tensor,
                                cfg: MFCCConfig = MFCCConfig()
                                ) -> torch.Tensor:
    """K3 as plain torch ops: the ``int_ops`` chain on the frames."""
    return int_ops.mfcc_int_frames(frames, cfg)


def _wire16(audio: torch.Tensor) -> torch.Tensor:
    """Samples mod 2^16 as int32 (the int16 wire contract)."""
    return framing.wrap_signed(audio.to(torch.int32), 16)


def _wire_audio(key: str, audio: torch.Tensor, cfg: MFCCConfig):
    """(x, lead, F): (..., T) int16 or int32 CUDA audio checked for
    ``key`` and flattened to (S, T) int16, int32 taken mod 2^16."""
    _check(audio, (torch.int16, torch.int32), key)
    lead, T = audio.shape[:-1], audio.shape[-1]
    F = framing.num_frames(T, cfg.hop, cfg.nfft)
    x = audio.reshape(-1, T)
    if x.dtype != torch.int16:
        x = framing.wrap_signed(x, 16).to(torch.int16)
    return x, lead, F


def _launch_audio(key: str, audio: torch.Tensor, cfg: MFCCConfig
                  ) -> torch.Tensor:
    """Launch K2's kernel on (..., T) int16 or int32 CUDA audio (int32
    taken mod 2^16 first), counted under ``key``."""
    x, lead, F = _wire_audio(key, audio, cfg)
    S, T = x.shape
    ops = int_operators(cfg, audio.device)
    tail = tail_args(cfg, ops)
    out = torch.empty((S, F, tail[1]), dtype=torch.int32, device=audio.device)
    _launch(key, build.library().mfcc_int_i16, audio, x.data_ptr(),
            out.data_ptr(), S, T, F, cfg.hop, *tail, *table_ptrs(ops))
    return out.reshape(lead + (F, tail[1]))


def _launch_frames(key: str, frames: torch.Tensor, cfg: MFCCConfig
                   ) -> torch.Tensor:
    """Launch K3's kernel on contiguous (..., F, 512) int32 CUDA frames,
    counted under ``key``."""
    _check(frames, (torch.int32,), key)
    if frames.dim() < 2 or frames.shape[-1] != cfg.nfft:
        raise ValueError(f"{key} takes (..., F, {cfg.nfft}) frames, got "
                         f"{tuple(frames.shape)}")
    lead = frames.shape[:-1]
    M = frames.numel() // cfg.nfft
    ops = int_operators(cfg, frames.device)
    tail = tail_args(cfg, ops)
    out = torch.empty((M, tail[1]), dtype=torch.int32, device=frames.device)
    _launch(key, build.library().mfcc_int_frames_i32, frames,
            frames.data_ptr(), out.data_ptr(), M, *tail, *table_ptrs(ops))
    return out.reshape(lead + (tail[1],))


def mfcc_int_fused(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                   ) -> torch.Tensor:
    """K2: (..., T) int16 or int32 audio -> (..., F, nceptrums) int32.  On
    a CUDA tensor this launches the kernel (int32 samples are taken mod
    2^16 first) or raises; a CPU tensor takes ``mfcc_int_fused_plain``."""
    _require_family(cfg)
    if audio.device.type == "cpu":
        return mfcc_int_fused_plain(audio, cfg)
    return _launch_audio("K2", audio, cfg)


def mfcc_int_fused_frames(frames: torch.Tensor,
                          cfg: MFCCConfig = MFCCConfig()) -> torch.Tensor:
    """K3: (..., F, 512) int32 pre-emphasized frames -> (..., F, nceptrums)
    int32.  On a CUDA tensor this launches the kernel or raises; a CPU
    tensor takes ``mfcc_int_fused_frames_plain``."""
    _require_family(cfg)
    if frames.device.type == "cpu":
        return mfcc_int_fused_frames_plain(frames, cfg)
    return _launch_frames("K3", frames, cfg)


# -- K9 and K3-v1: the v2 and v1 entries -------------------------------------------

def mfcc_int_v2(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                ) -> torch.Tensor:
    """K9, the counterpart of ``pallas_int.mfcc_int_pallas_v2``: K2's
    function and wire rule, (..., T) int16 or int32 -> (..., F, nceptrums)
    int32.  A CUDA tensor launches K2's kernel (counted as "K9") or raises;
    a CPU tensor takes ``mfcc_int_fused_plain``."""
    _require_family(cfg)
    if audio.device.type == "cpu":
        return mfcc_int_fused_plain(audio, cfg)
    return _launch_audio("K9", audio, cfg)


def mfcc_int_v1_plain(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                      ) -> torch.Tensor:
    """K3-v1 as plain torch ops: the ``int_ops`` chain on the samples as
    int32, with no mod 2^16 (``preemphasis_int`` wraps only its output)."""
    return int_ops.mfcc_int_batch(audio.to(torch.int32), cfg)


def mfcc_int_v1(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                ) -> torch.Tensor:
    """K3-v1, the counterpart of ``pallas_int.mfcc_int_pallas``: (..., T)
    samples of any integer-valued dtype (cast to int32 as they are) ->
    (..., F, nceptrums) int32.  On a CUDA tensor the pre-emphasis and the
    framing are torch ops, as they are XLA ops in JAX, and K3's kernel
    (counted as "K3-v1") windows and runs the rest, or the wrapper raises;
    a CPU tensor takes ``mfcc_int_v1_plain``."""
    _require_family(cfg)
    if audio.device.type == "cpu":
        return mfcc_int_v1_plain(audio, cfg)
    emph = framing.preemphasis_int(audio.to(torch.int32), width=cfg.width)
    frames = framing.extract_frames(emph, cfg.nfft, cfg.hop).contiguous()
    return _launch_frames("K3-v1", frames, cfg)


# -- K10: K2's function in two launches ------------------------------------------

def mfcc_int_front_plain(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                         ) -> torch.Tensor:
    """K10's first launch as plain torch ops: samples mod 2^16, emphasis,
    framing, window, FFT and power.  (..., T) -> (..., F, 256) int32."""
    emph = framing.preemphasis_int(_wire16(audio), width=cfg.width)
    frames = framing.extract_frames(emph, cfg.nfft, cfg.hop)
    return int_ops.power_frames_int(frames, cfg)


def mfcc_int_epi_plain(power: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                       ) -> torch.Tensor:
    """K10's second launch as plain torch ops: filterbank, log2 and DCT.
    (..., F, 256) int32 power -> (..., F, nceptrums) int32."""
    return int_ops.mfcc_int_from_power(power, cfg)


def mfcc_int_split2_plain(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                          ) -> torch.Tensor:
    """K10 as plain torch ops; the same function as K2's plain version."""
    return mfcc_int_epi_plain(mfcc_int_front_plain(audio, cfg), cfg)


def mfcc_int_front(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                   ) -> torch.Tensor:
    """K10's first launch: (..., T) int16 or int32 audio (int32 taken mod
    2^16) -> (..., F, 256) int32 power, natural bin order.  A CUDA tensor
    launches ``mfcc_int_front_i16`` or raises; a CPU tensor takes
    ``mfcc_int_front_plain``."""
    _require_family(cfg)
    if audio.device.type == "cpu":
        return mfcc_int_front_plain(audio, cfg)
    x, lead, F = _wire_audio("K10-front", audio, cfg)
    S, T = x.shape
    ops = int_operators(cfg, audio.device)
    nbins = cfg.nfft // 2
    power = torch.empty((S, F, nbins), dtype=torch.int32, device=audio.device)
    _launch("K10-front", build.library().mfcc_int_front_i16, audio,
            x.data_ptr(), power.data_ptr(), S, T, F, cfg.hop,
            ops.curve.data_ptr(), ops.tw.data_ptr())
    return power.reshape(lead + (F, nbins))


def mfcc_int_epi(power: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                 ) -> torch.Tensor:
    """K10's second launch: (..., F, 256) int32 power -> (..., F,
    nceptrums) int32.  A CUDA tensor launches ``mfcc_int_epi`` or raises;
    a CPU tensor takes ``mfcc_int_epi_plain``."""
    _require_family(cfg)
    if power.device.type == "cpu":
        return mfcc_int_epi_plain(power, cfg)
    _check(power, (torch.int32,), "K10-epi")
    nbins = cfg.nfft // 2
    if power.dim() < 1 or power.shape[-1] != nbins:
        raise ValueError(f"K10-epi takes (..., {nbins}) power rows, got "
                         f"{tuple(power.shape)}")
    lead = power.shape[:-1]
    M = power.numel() // nbins
    ops = int_operators(cfg, power.device)
    tail = tail_args(cfg, ops)
    out = torch.empty((M, tail[1]), dtype=torch.int32, device=power.device)
    _launch("K10-epi", build.library().mfcc_int_epi, power, power.data_ptr(),
            out.data_ptr(), M, *tail, ops.dtw.data_ptr(), ops.fbw.data_ptr(),
            ops.band.data_ptr())
    return out.reshape(lead + (tail[1],))


def mfcc_int_split2(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                    ) -> torch.Tensor:
    """K10, the counterpart of ``tools/ab_int_r5.split2_build``: K2's
    function, (..., T) int16 or int32 -> (..., F, nceptrums) int32, as
    ``mfcc_int_front`` then ``mfcc_int_epi``.  A CPU tensor takes the
    plain versions of both."""
    return mfcc_int_epi(mfcc_int_front(audio, cfg), cfg)
