"""K8: the dense-DFT float MFCC, one CUDA kernel behind seven entry points.

The counterpart of the legacy dense-DFT kernels of
``mfcc_tpu.ops.pallas_mfcc``, which multiply each frame by the (nfft, nfft)
windowed real-DFT operator ``CS`` (the Nyquist bin dropped), then take the
power, the mel product, log2 and the DCT.  Each entry keeps its JAX
counterpart's ``split`` default:

  ============================  ============================  =========  ======
  entry                         JAX entry (kernel)            ingest     split
  ============================  ============================  =========  ======
  ``mfcc_emphasized``           ``mfcc_pallas_emphasized``    emphasized False
                                (``_mfcc_kernel``)
  ``mfcc_batch_dense``          ``mfcc_batch_pallas``         emphasize  False
                                (``_mfcc_kernel``)
  ``mfcc_raw``                  ``mfcc_pallas_raw``           fold       True
                                (``_mfcc_raw_kernel``)
  ``mfcc_aligned``              ``mfcc_pallas_aligned``       emphasize  True
                                (``_mfcc_aligned_kernel``)
  ``mfcc_recomp``               ``mfcc_pallas_recomp``        emphasize  True
                                (``_mfcc_recomp_kernel``)
  ``mfcc_seg``                  ``mfcc_pallas_seg``           emphasize  True
                                (``_mfcc_seg_kernel``)
  ``mfcc_fmaj``                 ``mfcc_pallas_fmaj``          emphasize  False
                                (``_mfcc_fmaj_kernel``)
  ============================  ============================  =========  ======

The ingest modes: "emphasized" takes emphasized f32 audio; "emphasize"
takes raw audio and emphasizes it in f32, x - 0.96875*p rounded twice (what
``framing.preemphasis`` computes, and what the recomp and fmaj kernels do
inside); "fold" takes raw audio against the 513-row operator
CS2[j] = CS[j-1] - 0.96875*CS[j], rounded to f32 before anything else as
JAX does (``pallas_mfcc.py:233-239``), each frame extended by the sample
before it (0 before a stream's first).  ``mfcc_aligned`` keeps JAX's nfft
512 / hop 170 restriction.  ``mfcc_seg`` sums the same products as the
dense DFT: its segment operators are a TPU layout of ``CS`` and in float64
the segment sum is the dense sum.  JAX's ``bf`` and ``interpret`` arguments
set TPU block sizes and the Pallas interpreter and have no counterpart.

The function the kernel (``csrc/dense_dft.cu``) and the plain versions
share: f32 frames; with ``split`` each operand (frames and operator)
replaced by hi + lo, its two bf16 limbs rounded to nearest even (the TPU's
four limb passes); the product summed in float64 (exact f32 products);
power, mel, optional ``mel_floor`` (fmaj only, as in JAX), log2 and the DCT
in float64, rounded to f32 once.  The mel and DCT matrices are JAX's f32
operators.  A CUDA tensor launches the kernel (or the wrapper raises), a
CPU tensor takes the entry's plain version (``*_plain``).  ``LAUNCHES``
counts kernel launches per entry.
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
from .fladder import mel_bands
from .float_fused import _limbs, float_config_ok

# kernel launches per entry (never the plain versions)
LAUNCHES = {"emphasized": 0, "batch": 0, "raw": 0, "aligned": 0,
            "recomp": 0, "seg": 0, "fmaj": 0}

# the kernel's ingest modes (csrc/dense_dft.cu)
EMPHASIZED, EMPHASIZE, FOLD = 0, 1, 2


@functools.lru_cache(maxsize=None)
def kernel_operators(cfg: MFCCConfig) -> tuple[np.ndarray, ...]:
    """(CS, mel, dct) as float32 numpy arrays, the counterpart of
    ``pallas_mfcc._kernel_operators``: CS (nfft, nfft) holds the windowed
    cos columns of bins [0, nfft/2) then the -sin columns; mel (nfft/2,
    nfilters) without the Nyquist row; dct (nfilters, nceptrums)."""
    C, S = tables.windowed_rdft_matrix(cfg.nfft)
    nb = cfg.nfft // 2
    CS = np.concatenate([C[:, :nb], S[:, :nb]], axis=1).astype(np.float32)
    mel = tables.float_mel_matrix(cfg.samplerate, cfg.nfft,
                                  cfg.nfilters)[:nb].astype(np.float32)
    dct = tables.dct2_ortho_matrix(cfg.nfilters)[:, : cfg.nceptrums]
    return CS, mel, dct.astype(np.float32)


@functools.lru_cache(maxsize=None)
def kernel_operators_folded(cfg: MFCCConfig) -> tuple[np.ndarray, ...]:
    """(CS2, mel, dct), the counterpart of
    ``pallas_mfcc._kernel_operators_folded``: the emphasis folded into a
    (nfft + 1, nfft) f32 operator, CS2[j] = CS[j-1] - 0.96875*CS[j] with
    the boundary rows taken once, in f32."""
    CS, mel, dct = kernel_operators(cfg)
    CS2 = np.zeros((cfg.nfft + 1, CS.shape[1]), np.float32)
    CS2[1:] += CS
    CS2[:-1] -= np.float32(framing.EMPHASIS_COEFF) * CS
    return CS2, mel, dct


def limb_sum(x: torch.Tensor) -> torch.Tensor:
    """hi + lo of an f32 tensor's two bf16 limbs (``float_fused._limbs``:
    both rounded to nearest even); exact in f32."""
    hi, lo = _limbs(x)
    return hi + lo


class DenseOperators(NamedTuple):
    """K8's operators on one device."""
    cs: torch.Tensor     # (K, nfft) float32, limb sums when split
    mel: torch.Tensor    # (nfft/2, nfilters) float64 (f32 values)
    dct: torch.Tensor    # (nfilters, nceptrums) float64 (f32 values)
    band: torch.Tensor   # (nfilters, 2) int32 mel_bands(mel)


@functools.lru_cache(maxsize=None)
def dense_operators(cfg: MFCCConfig, device: torch.device, fold: bool,
                    split: bool) -> DenseOperators:
    """The operators of one (fold, split) form as tensors on ``device``,
    cached per (cfg, device, fold, split)."""
    cs, mel, dct = (kernel_operators_folded if fold else kernel_operators)(cfg)
    cs = torch.as_tensor(cs, device=device)
    if split:
        cs = limb_sum(cs)
    mel = torch.as_tensor(mel, device=device).double()
    return DenseOperators(cs.contiguous(), mel,
                          torch.as_tensor(dct, device=device).double(),
                          mel_bands(mel))


def _require_family(cfg: MFCCConfig) -> None:
    if not float_config_ok(cfg):
        raise ValueError(f"config outside K8's family (nfft 256/512/1024, "
                         f"windowlen == nfft, zero Nyquist mel row): {cfg}")


def _as_audio(audio: torch.Tensor, ingest: int) -> torch.Tensor:
    """int16 stays int16 on the raw ingests (the wire type); anything else
    becomes f32, as the JAX entry points cast on the host."""
    if audio.dtype == torch.int16 and ingest != EMPHASIZED:
        return audio
    return audio.to(torch.float32)


# -- plain versions -----------------------------------------------------------------

def dense_tail_plain(frames: torch.Tensor, ops: DenseOperators,
                     cfg: MFCCConfig, split: bool, mel_floor: float = 0.0
                     ) -> torch.Tensor:
    """K8's function from (..., F, K) f32 frames (K = nfft, or nfft + 1
    folded) -> (..., F, ncep) f32: limb sums when ``split``, the product
    in float64, power, mel, floor, log2 and DCT in float64."""
    x = frames.to(torch.float32)
    if split:
        x = limb_sum(x)
    reim = x.double() @ ops.cs.double()
    nb = cfg.nfft // 2
    re, im = reim[..., :nb], reim[..., nb:]
    melspec = (re * re + im * im) @ ops.mel
    if mel_floor:
        melspec = torch.clamp_min(melspec, mel_floor)
    return (torch.log2(melspec) @ ops.dct).to(torch.float32)


def _frames_plain(x: torch.Tensor, cfg: MFCCConfig, ingest: int
                  ) -> torch.Tensor:
    """The f32 frames the kernel builds from (..., T) input."""
    x = x.to(torch.float32)
    if ingest == EMPHASIZE:
        x = framing.preemphasis(x)
    elif ingest == FOLD:    # frame g is x[g*hop - 1 .. g*hop + nfft - 1]
        x = torch.cat([x.new_zeros(x.shape[:-1] + (1,)), x], dim=-1)
        return x.unfold(-1, cfg.nfft + 1, cfg.hop)
    return framing.extract_frames(x, cfg.nfft, cfg.hop)


def _plain(audio: torch.Tensor, cfg: MFCCConfig, ingest: int, split: bool,
           mel_floor: float = 0.0) -> torch.Tensor:
    _require_family(cfg)
    framing.num_frames(audio.shape[-1], cfg.hop, cfg.nfft)
    ops = dense_operators(cfg, audio.device, ingest == FOLD, split)
    return dense_tail_plain(_frames_plain(audio, cfg, ingest), ops, cfg,
                            split, mel_floor)


def mfcc_emphasized_plain(emph: torch.Tensor, cfg: MFCCConfig = MFCCConfig(),
                          *, split: bool = False) -> torch.Tensor:
    return _plain(emph, cfg, EMPHASIZED, split)


def mfcc_batch_dense_plain(audio: torch.Tensor,
                           cfg: MFCCConfig = MFCCConfig(), *,
                           split: bool = False) -> torch.Tensor:
    return _plain(audio, cfg, EMPHASIZE, split)


def mfcc_raw_plain(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                   ) -> torch.Tensor:
    return _plain(audio, cfg, FOLD, True)


def mfcc_aligned_plain(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(),
                       *, split: bool = True) -> torch.Tensor:
    _require_aligned(cfg)
    return _plain(audio, cfg, EMPHASIZE, split)


def mfcc_recomp_plain(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(),
                      *, split: bool = True) -> torch.Tensor:
    return _plain(audio, cfg, EMPHASIZE, split)


def mfcc_seg_plain(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
                   split: bool = True) -> torch.Tensor:
    return _plain(audio, cfg, EMPHASIZE, split)


def mfcc_fmaj_plain(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
                    mel_floor: float = 0.0) -> torch.Tensor:
    return _plain(audio, cfg, EMPHASIZE, False, mel_floor)


# -- the kernel ------------------------------------------------------------------------

def _run(key: str, audio: torch.Tensor, cfg: MFCCConfig, ingest: int,
         split: bool, mel_floor: float = 0.0) -> torch.Tensor:
    """(..., T) -> (..., F, ncep) f32: launch ``mfcc_dense_{i16,f32}`` on a
    CUDA tensor (counted under ``key``) or raise; the plain version on a
    CPU tensor."""
    if audio.device.type == "cpu":
        return _plain(audio, cfg, ingest, split, mel_floor)
    if audio.device.type != "cuda":
        raise ValueError(f"K8 runs on CUDA or CPU tensors, got {audio.device}")
    _require_family(cfg)
    x = _as_audio(audio, ingest).contiguous()
    lead, T = x.shape[:-1], x.shape[-1]
    n_frames = framing.num_frames(T, cfg.hop, cfg.nfft)
    x = x.reshape(-1, T)
    S = x.shape[0]
    ops = dense_operators(cfg, x.device, ingest == FOLD, split)
    ncep = ops.dct.shape[1]
    out = torch.empty((S, n_frames, ncep), dtype=torch.float32,
                      device=x.device)
    lib = build.library()
    fn = lib.mfcc_dense_i16 if x.dtype == torch.int16 else lib.mfcc_dense_f32
    build.launch(fn, x.device, x.data_ptr(), out.data_ptr(), S, T, n_frames,
                 cfg.hop, cfg.nfft, cfg.nfilters, ncep, ingest, int(split),
                 ops.cs.data_ptr(), ops.mel.data_ptr(), ops.dct.data_ptr(),
                 ops.band.data_ptr(), float(mel_floor))
    LAUNCHES[key] += 1
    return out.reshape(lead + (n_frames, ncep))


def mfcc_emphasized(emph: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
                    split: bool = False) -> torch.Tensor:
    """The counterpart of ``pallas_mfcc.mfcc_pallas_emphasized``: (..., T)
    already-emphasized audio (cast to f32) -> (..., F, ncep) f32."""
    return _run("emphasized", emph, cfg, EMPHASIZED, split)


def mfcc_batch_dense(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
                     split: bool = False) -> torch.Tensor:
    """The counterpart of ``pallas_mfcc.mfcc_batch_pallas``: the f32
    emphasis, then ``mfcc_emphasized``'s function, in one launch."""
    return _run("batch", audio, cfg, EMPHASIZE, split)


def mfcc_raw(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
             ) -> torch.Tensor:
    """The counterpart of ``pallas_mfcc.mfcc_pallas_raw``: raw audio
    against the folded operator CS2, always split."""
    return _run("raw", audio, cfg, FOLD, True)


def _require_aligned(cfg: MFCCConfig) -> None:
    if cfg.nfft != 512 or cfg.hop != 170:
        raise ValueError(f"mfcc_aligned takes nfft 512 and hop 170 only, as "
                         f"mfcc_pallas_aligned does: {cfg}")


def mfcc_aligned(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
                 split: bool = True) -> torch.Tensor:
    """The counterpart of ``pallas_mfcc.mfcc_pallas_aligned`` (nfft 512,
    hop 170 only)."""
    _require_aligned(cfg)
    return _run("aligned", audio, cfg, EMPHASIZE, split)


def mfcc_recomp(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
                split: bool = True) -> torch.Tensor:
    """The counterpart of ``pallas_mfcc.mfcc_pallas_recomp``: raw audio,
    the f32 emphasis in the kernel."""
    return _run("recomp", audio, cfg, EMPHASIZE, split)


def mfcc_seg(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
             split: bool = True) -> torch.Tensor:
    """The counterpart of ``pallas_mfcc.mfcc_pallas_seg``: the segment sum
    taken as the dense product."""
    return _run("seg", audio, cfg, EMPHASIZE, split)


def mfcc_fmaj(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
              mel_floor: float = 0.0) -> torch.Tensor:
    """The counterpart of ``pallas_mfcc.mfcc_pallas_fmaj``: raw int16 (on
    the wire as int16) or float audio, the f32 emphasis in the kernel, the
    f32 product (no split), ``mel_floor``."""
    return _run("fmaj", audio, cfg, EMPHASIZE, False, mel_floor)
