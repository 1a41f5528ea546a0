"""K7: the ``precision="f64ish"`` accuracy dial, in FP64.

The counterpart of ``mfcc_tpu.ops.df32`` (the compensated double-f32 chain)
and ``mfcc_tpu.ops.pallas_df32`` (its fused TPU kernel, K7): MFCC within
the elementwise max(1e-5, 2 ulp) gate of the float64 oracle.  The TPU has
no FP64, so the JAX package carries double-f32 limbs, TwoSums, limb
matmuls and a LUT log2 to reach that gate; the H100 has FP64, so the port
computes the same function in float64 and rounds to f32 once, at the
output (K7's ingests on the FP64 tail's walk, ``csrc/fladder.cu``).
None of the double-f32 machinery is carried, and neither is the JAX
functions' ``group`` argument (a chunk length of the f32 accumulation,
meaningless in FP64).

The function, as ``df32.mfcc_batch_f64ish`` defines it:

  * pre-emphasis ``x - 0.96875*prev`` in f32, rounded twice (exact for
    int16-range samples);
  * with ``wire_grid`` (the default), the emphasized samples rounded to the
    2^-5 grid half to even (``torch.round``, as ``jnp.round``): a no-op on
    emphasized int16-range samples, which lie on the grid;
  * window, FFT, power, mel (no ``mel_floor``), log2 and DCT in float64.

``wire_grid=True`` is defined for int16-range samples: the JAX chain takes
``round(x*32)`` to int32, which wraps beyond 2^26 (samples of 2^20 scale
already differ), while the port rounds in float64 and never wraps.  Off the
grid the JAX kernel K7 truncates ``x*32`` where the JAX chain rounds it (up
to 4.1 apart on [-1, 1] input); the pipeline's route is the chain, and the
port follows it.

Routes, as ``df32`` and ``pallas_df32`` split them:

  * ``mfcc_batch_f64ish`` / ``mfcc_frames_f64ish`` take any config: one in
    K7's family (``f64ish_config_ok``) goes to the kernel wrappers, any
    other to a float64 chain over all ``nbins_float`` bins;
  * the kernel wrappers ``mfcc_f64ish`` (K7, from (..., T) audio; framing
    is addressing in the kernel) and ``mfcc_f64ish_frames`` (K7-frames,
    from (..., F, nfft) pre-emphasized frames) launch the kernel on a CUDA
    tensor or raise; a CPU tensor takes the plain version
    (``mfcc_batch_f64ish_plain``, ``mfcc_frames_f64ish_plain``).

``LAUNCHES`` counts kernel launches per kernel.
"""

from __future__ import annotations

import torch

from ..config import MFCCConfig
from . import fladder, framing

# kernel launches per kernel (never the plain versions)
LAUNCHES = {"K7": 0, "K7-frames": 0}

GRID = 32.0     # the wire grid, 2^-5: emphasized int16 samples lie on it


def f64ish_config_ok(cfg: MFCCConfig) -> bool:
    """K7's family: ``pallas_df32.pallas_f64ish_config_ok`` (nfft in {256,
    512, 1024}, full-length windows) and a zero Nyquist mel row.  The JAX
    kernel drops the Nyquist bin whatever its mel row holds; the port
    drops it only where that changes nothing, and sends other configs to
    the float64 chain.  Any hop: the kernel frames by address."""
    return (cfg.nfft in (256, 512, 1024) and cfg.windowlen == cfg.nfft
            and fladder.nyquist_mel_row_zero(cfg))


def _as_audio(audio: torch.Tensor) -> torch.Tensor:
    """int16 stays int16 (the wire type, exact in f32); any other dtype
    becomes f32, as ``df32`` casts."""
    return audio if audio.dtype == torch.int16 else audio.to(torch.float32)


# -- plain versions -----------------------------------------------------------

def mfcc_frames_f64ish_plain(frames: torch.Tensor,
                             cfg: MFCCConfig = MFCCConfig(), *,
                             wire_grid: bool = True, operators=None
                             ) -> torch.Tensor:
    """f64ish MFCC of pre-emphasized frames as plain torch ops: (..., F,
    nfft) -> (..., F, ncep) f32.  Frames are taken as f32 (as ``df32``
    casts them), then float64; with ``wire_grid`` rounded to the 2^-5 grid
    half to even.  In K7's family the tail is K1's float64 tail
    (``fladder.ladder_tail_plain``, bins [0, nfft/2)), with ``operators`` a
    ``fladder.LadderOperators``; any other config takes the float64
    ``float_ops`` chain over all ``nbins_float`` bins, with ``operators``
    float64 ``float_ops.Operators``."""
    x = frames.to(torch.float32).to(torch.float64)
    if wire_grid:
        x = torch.round(x * GRID) / GRID
    if f64ish_config_ok(cfg):
        ops = (operators if operators is not None
               else fladder.default_operators(cfg, x.device))
        return fladder.ladder_tail_plain(x, ops, cfg)
    from . import float_ops
    return float_ops.mfcc_frames(x, cfg, dtype=torch.float64,
                                 operators=operators).to(torch.float32)


def mfcc_batch_f64ish_plain(audio: torch.Tensor,
                            cfg: MFCCConfig = MFCCConfig(), *,
                            wire_grid: bool = True, operators=None
                            ) -> torch.Tensor:
    """f64ish MFCC of raw signals as plain torch ops: (..., T) -> (..., F,
    ncep) f32; the pre-emphasis in f32, rounded twice, then framing and
    ``mfcc_frames_f64ish_plain``."""
    emph = framing.preemphasis(audio.to(torch.float32))
    frames = framing.extract_frames(emph, cfg.nfft, cfg.hop,
                                    windowlen=cfg.windowlen)
    return mfcc_frames_f64ish_plain(frames, cfg, wire_grid=wire_grid,
                                    operators=operators)


# -- the kernels ----------------------------------------------------------------

def mfcc_f64ish(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
                wire_grid: bool = True,
                operators: fladder.LadderOperators | None = None
                ) -> torch.Tensor:
    """K7, the counterpart of ``pallas_df32.mfcc_f64ish_pallas``: (..., T)
    int16 or float audio (int16 stays int16, any other dtype becomes f32)
    -> (..., F, ncep) f32.  A CUDA tensor launches the FP64 tail's walk
    with K7's ingest (``fladder.launch_tail``) or raises; a CPU tensor
    takes ``mfcc_batch_f64ish_plain``."""
    if not f64ish_config_ok(cfg):
        raise ValueError(f"config outside K7's family: {cfg}")
    if audio.device.type == "cpu":
        return mfcc_batch_f64ish_plain(audio, cfg, wire_grid=wire_grid,
                                       operators=operators)
    F = framing.num_frames(audio.shape[-1], cfg.hop, cfg.nfft)
    out = fladder.launch_tail(fladder.F64ISH, _as_audio(audio).contiguous(),
                              F, cfg.hop, cfg, operators, what="K7",
                              wire_grid=wire_grid)
    LAUNCHES["K7"] += 1
    return out


def mfcc_f64ish_frames(frames: torch.Tensor, cfg: MFCCConfig = MFCCConfig(),
                       *, wire_grid: bool = True,
                       operators: fladder.LadderOperators | None = None
                       ) -> torch.Tensor:
    """K7-frames, the counterpart of ``pallas_df32.mfcc_f64ish_pallas_frames``:
    (..., F, nfft) pre-emphasized frames of any float dtype (taken as f32)
    -> (..., F, ncep) f32.  A CUDA tensor launches the FP64 tail's walk
    with K7-frames' ingest (``fladder.launch_tail``) or raises; a CPU
    tensor takes ``mfcc_frames_f64ish_plain``."""
    if frames.dim() < 1 or frames.shape[-1] != cfg.nfft:
        raise ValueError(f"K7-frames takes (..., F, {cfg.nfft}) frames, got "
                         f"{tuple(frames.shape)}")
    if not f64ish_config_ok(cfg):
        raise ValueError(f"config outside K7-frames's family: {cfg}")
    if frames.device.type == "cpu":
        return mfcc_frames_f64ish_plain(frames, cfg, wire_grid=wire_grid,
                                        operators=operators)
    out = fladder.launch_tail(fladder.F64ISH_FRAMES,
                              frames.to(torch.float32).contiguous(), 1,
                              cfg.hop, cfg, operators, what="K7-frames",
                              wire_grid=wire_grid)
    LAUNCHES["K7-frames"] += 1
    return out.squeeze(-2)


# -- routes (any config) ---------------------------------------------------------

def mfcc_batch_f64ish(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
                      wire_grid: bool = True, operators=None) -> torch.Tensor:
    """``df32.mfcc_batch_f64ish``: (..., T) -> (..., F, ncep) f32 for any
    config; K7's family takes ``mfcc_f64ish``, any other config the float64
    chain (``operators`` as ``mfcc_frames_f64ish_plain`` takes them)."""
    if f64ish_config_ok(cfg):
        return mfcc_f64ish(audio, cfg, wire_grid=wire_grid,
                           operators=operators)
    return mfcc_batch_f64ish_plain(audio, cfg, wire_grid=wire_grid,
                                   operators=operators)


def mfcc_frames_f64ish(frames: torch.Tensor, cfg: MFCCConfig = MFCCConfig(),
                       *, wire_grid: bool = True, operators=None
                       ) -> torch.Tensor:
    """``df32.mfcc_frames_f64ish``: (..., F, nfft) -> (..., F, ncep) f32 for
    any config; K7's family takes ``mfcc_f64ish_frames``, any other config
    the float64 chain."""
    if f64ish_config_ok(cfg):
        return mfcc_f64ish_frames(frames, cfg, wire_grid=wire_grid,
                                  operators=operators)
    return mfcc_frames_f64ish_plain(frames, cfg, wire_grid=wire_grid,
                                    operators=operators)
