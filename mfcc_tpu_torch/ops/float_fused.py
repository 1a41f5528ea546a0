"""K5 and K6: the fused float kernels of the ``precision="fast"`` dial and
of odd hops.

The counterpart of ``mfcc_tpu.ops.pallas_mfcc`` as far as the public routes
reach it:

  * ``mfcc_radix2`` (K5): (..., T) int16 or f32 audio -> (..., F, ncep) f32
    through the split DFT: pre-emphasis and framing, the window on the even
    and odd frame positions, the nfft/2-point DFT of each half as a product
    with a cos / -sin operator, twiddle recombination, power on bins
    [0, nfft/2), mel, optional ``mel_floor``, log2 and the DCT, all in f32
    (``csrc/float_fused.cu``, the tail in ``csrc/radix2_stages.cuh``);
  * ``mfcc_frames_float`` (K5 frames): the same tail on (..., F, nfft)
    pre-emphasized frames of any float dtype;
  * ``mfcc_recomp_t`` (K6): the float MFCC at any hop.  On the TPU it is a
    dense f32 DFT because the split-DFT and ladder layouts need an even
    hop; on the card K1's kernel (``csrc/fladder.cu``) frames by address,
    so K6 launches ``mfcc_fladder_{i16,f32}`` with the odd hop, and its
    FP64 interior holds the 5e-4 contract.

``dft_passes`` (3, 4 or 6, per call) selects the DFT product's form.  At 6
it is the product of the f32 operands.  At 3 and 4 both operands are split
into two bf16 limbs (hi = bf16(x), lo = bf16(x - hi)) and the limb products
hi*hi, hi*lo, lo*hi (and lo*lo at 4) are summed, as the JAX kernel does on
the MXU: the limb split sets the fast mode's error against the float64
oracle, so the port keeps it.  The JAX kernel sums in f32; the port sums
the (exact) products in float64 and rounds to f32 once, in the kernel and
the plain version alike.  On the quiet mel bands of long inputs two f32
summation orders differ by ~1.5e-3 after log2, so an f32 sum could not be
held against its plain version; the rest of the tail stays f32.

A CUDA tensor launches the kernel (or the wrapper raises), a CPU tensor
takes the plain version: ``mfcc_radix2_plain``, ``mfcc_frames_float_plain``
(on ``radix2_tail_plain``) and ``fladder.mfcc_float_ladder_plain`` for K6.
``LAUNCHES`` counts kernel launches per kernel.

The operators are in natural bin order: cos rows j = 0..nfft/4, then -sin
rows j = 1..nfft/4-1.  The TPU layouts (the 256-row ``pack256`` operator
with the cos-bin-nfft/4 row parked last and its circular roll, ``melc``,
positions-major (hop, bf) tiles, ``kernel_t``, ``NBMAX`` super-blocks with
an SMEM carry) and the module globals ``R2_DFT_PASSES``, ``R2_KERNEL_T``,
``R2_PACK256`` and ``NBMAX`` have no counterpart here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import MFCCConfig
from .. import tables
from ..kernels import build
from . import fladder, framing

# kernel launches per kernel (never the plain versions)
LAUNCHES = {"K5": 0, "K5-frames": 0, "K6": 0}

PASSES = (3, 4, 6)


def float_config_ok(cfg: MFCCConfig) -> bool:
    """The fused float kernels' family, the same predicate as
    ``mfcc_tpu.ops.pallas_mfcc.pallas_float_config_ok``: nfft in {256, 512,
    1024}, full-length windows and a zero Nyquist mel row; any hop."""
    return (cfg.windowlen == cfg.nfft and cfg.nfft in (256, 512, 1024)
            and fladder.nyquist_mel_row_zero(cfg))


class Radix2Tables(NamedTuple):
    """The split-DFT operators as float32 numpy arrays (nh = nfft/2)."""
    cos: np.ndarray      # (nh,) cos(2*pi*i/nh) / nfft
    sin: np.ndarray      # (nh,) -sin(2*pi*i/nh) / nfft
    dft: np.ndarray      # (nh, nh): rows [0, nh/2] cos j, rows (nh/2, nh)
    #                      -sin j = 1..nh/2-1; row j col m = table[j*m % nh]
    we: np.ndarray       # (nh,) Hamming window at the even frame positions
    wo: np.ndarray       # (nh,) ... at the odd positions
    tw: np.ndarray       # (nh/2, 2) [cos, sin](2*pi*j/nfft)
    mel: np.ndarray      # (nh, nfilters), the Nyquist row dropped
    dct: np.ndarray      # (nfilters, nceptrums)


def check_passes(dft_passes: int) -> int:
    if dft_passes not in PASSES:
        raise ValueError(f"dft_passes must be one of {PASSES}, got "
                         f"{dft_passes!r}")
    return dft_passes


@functools.lru_cache(maxsize=None)
def radix2_operators(cfg: MFCCConfig) -> Radix2Tables:
    """The counterpart of ``pallas_mfcc._radix2_operators``, in natural bin
    order.  The kernel reads the nh-entry cos and -sin tables, since the
    operator is circulant in index (row j, column m is entry j*m mod nh);
    the plain version reads ``dft``, built from the same tables, so both
    see the same values.  Raises ``ValueError`` outside
    ``float_config_ok``'s nfft family or for a non-zero Nyquist mel row."""
    nfft = cfg.nfft
    if nfft not in (256, 512, 1024) or cfg.windowlen != nfft:
        raise ValueError(f"the split-DFT operators need nfft in (256, 512, "
                         f"1024) and windowlen == nfft: {cfg}")
    if not fladder.nyquist_mel_row_zero(cfg):
        raise ValueError("the split-DFT kernels drop the Nyquist bin; its "
                         f"mel row must be zero: {cfg}")
    nh, nh2 = nfft // 2, nfft // 4
    ang = 2 * np.pi * np.arange(nh) / nh
    cos = (np.cos(ang) / nfft).astype(np.float32)
    sin = (-np.sin(ang) / nfft).astype(np.float32)
    jm = np.arange(nh)[:, None] * np.arange(nh)[None, :] % nh
    dft = np.concatenate([cos[jm[: nh2 + 1]], sin[jm[1: nh2]]], axis=0)
    w = tables.float_window(nfft)
    a = 2 * np.pi * np.arange(nh2) / nfft
    tw = np.stack([np.cos(a), np.sin(a)], axis=1).astype(np.float32)
    mel = tables.float_mel_matrix(cfg.samplerate, nfft, cfg.nfilters)[:nh]
    dct = tables.dct2_ortho_matrix(cfg.nfilters)[:, : cfg.nceptrums]
    f32 = functools.partial(np.ascontiguousarray, dtype=np.float32)
    return Radix2Tables(cos, sin, f32(dft), f32(w[0::2]), f32(w[1::2]), tw,
                        f32(mel), f32(dct))


class Radix2Operators(NamedTuple):
    """``radix2_operators`` as float32 tensors on one device, with the mel
    band limits (int32) the kernel sums over."""
    cos: torch.Tensor
    sin: torch.Tensor
    dft: torch.Tensor
    we: torch.Tensor
    wo: torch.Tensor
    tw: torch.Tensor
    mel: torch.Tensor
    dct: torch.Tensor
    band: torch.Tensor


@functools.lru_cache(maxsize=None)
def default_operators(cfg: MFCCConfig, device: torch.device
                      ) -> Radix2Operators:
    """``radix2_operators(cfg)`` as tensors, cached per (cfg, device)."""
    ts = [torch.as_tensor(a, device=device) for a in radix2_operators(cfg)]
    return Radix2Operators(*ts, fladder.mel_bands(ts[6]))


# -- plain versions --------------------------------------------------------------

def _limbs(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bf16 limbs of an f32 tensor, as f32: hi = bf16(x) and
    lo = bf16(x - hi), both rounded to nearest even."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def _operand(x: torch.Tensor, dft_passes: int
             ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(s, l) in float64: s = x at 6 passes, else hi + lo (exact); l = lo at
    3 passes, else None."""
    if dft_passes == 6:
        return x.double(), None
    hi, lo = _limbs(x)
    lo = lo.double()
    return hi.double() + lo, (lo if dft_passes == 3 else None)


def split_dft_plain(x: torch.Tensor, op: torch.Tensor, dft_passes: int
                    ) -> torch.Tensor:
    """(..., nh) f32 @ op.T in the form ``dft_passes`` selects, rounded to
    f32 once: x*op at 6 passes; at 3 (4) the limb products hi*hi + hi*lo +
    lo*hi (+ lo*lo) of ``pallas_mfcc._radix2_core``, taken as (hi+lo)(hi+lo)
    (- lo*lo).  Every product is exact in float64 and the sums are float64,
    so the kernel's order of summation does not show in its f32 result."""
    xs, xl = _operand(x, dft_passes)
    cs, cl = _operand(op, dft_passes)
    out = xs @ cs.T
    if dft_passes == 3:
        out = out - xl @ cl.T
    return out.to(torch.float32)


def radix2_tail_plain(frames: torch.Tensor, ops: Radix2Operators,
                      cfg: MFCCConfig, dft_passes: int = 6,
                      mel_floor: float = 0.0) -> torch.Tensor:
    """The split-DFT tail as plain torch ops on (..., F, nfft) f32
    pre-emphasized frames -> (..., F, ncep) f32, the twin of
    ``pallas_mfcc._radix2_core`` in natural bin order.  Shared by K5's,
    K5-frames' and the split-DFT serving step's plain versions."""
    nh, nh2 = cfg.nfft // 2, cfg.nfft // 4
    x = torch.stack([frames[..., 0::2] * ops.we, frames[..., 1::2] * ops.wo],
                    dim=-2)                                  # (..., F, 2, nh)
    eo = split_dft_plain(x, ops.dft, check_passes(dft_passes))
    re = eo[..., : nh2 + 1]                                  # cos j = 0..nh2
    im = torch.cat([torch.zeros_like(eo[..., :1]), eo[..., nh2 + 1:]],
                   dim=-1)                                   # -sin j < nh2
    ere, ore = re[..., 0, :nh2], re[..., 1, :nh2]
    eim, oim = im[..., 0, :], im[..., 1, :]
    twc, tws = ops.tw[:, 0], ops.tw[:, 1]
    tre = twc * ore + tws * oim                              # W^j O_j
    tim = twc * oim - tws * ore
    are, aim = ere + tre, eim + tim                          # bins j
    bre, bim = ere - tre, eim - tim                          # bins nh - j
    pa = are * are + aim * aim
    pb = bre * bre + bim * bim
    mid = re[..., 0, nh2] * re[..., 0, nh2] + re[..., 1, nh2] * re[..., 1, nh2]
    power = torch.cat([pa, mid[..., None], pb[..., 1:].flip(-1)], dim=-1)
    melspec = power @ ops.mel
    if mel_floor:
        melspec = torch.clamp_min(melspec, mel_floor)
    return torch.log2(melspec) @ ops.dct


def _as_audio(audio: torch.Tensor) -> torch.Tensor:
    """int16 stays int16 (the wire type); any other dtype becomes f32, as
    the JAX entry points cast on the host."""
    return audio if audio.dtype == torch.int16 else audio.to(torch.float32)


def mfcc_radix2_plain(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(),
                      *, dft_passes: int = 6, mel_floor: float = 0.0,
                      operators: Radix2Operators | None = None
                      ) -> torch.Tensor:
    """K5 as plain torch ops: (..., T) -> (..., F, ncep) f32; the emphasis
    x - 0.96875*p in f32, rounded twice."""
    ops = operators or default_operators(cfg, audio.device)
    emph = framing.preemphasis(_as_audio(audio).to(torch.float32))
    frames = framing.extract_frames(emph, cfg.nfft, cfg.hop)
    return radix2_tail_plain(frames, ops, cfg, dft_passes, mel_floor)


def mfcc_frames_float_plain(frames: torch.Tensor,
                            cfg: MFCCConfig = MFCCConfig(), *,
                            dft_passes: int = 6, mel_floor: float = 0.0,
                            operators: Radix2Operators | None = None
                            ) -> torch.Tensor:
    """K5-frames as plain torch ops: (..., F, nfft) -> (..., F, ncep)."""
    ops = operators or default_operators(cfg, frames.device)
    return radix2_tail_plain(frames.to(torch.float32), ops, cfg, dft_passes,
                             mel_floor)


# -- the kernels ------------------------------------------------------------------

def check_operators(ops: Radix2Operators, cfg: MFCCConfig,
                    device: torch.device, what: str) -> None:
    """Raise unless the operators are the contiguous float32 (int32 band)
    tensors of ``cfg``'s shapes on ``device`` that the kernels read."""
    nh, nf, ncep = cfg.nfft // 2, cfg.nfilters, cfg.nceptrums
    for name, shape, dtype in (
            ("cos", (nh,), torch.float32), ("sin", (nh,), torch.float32),
            ("dft", (nh, nh), torch.float32), ("we", (nh,), torch.float32),
            ("wo", (nh,), torch.float32), ("tw", (nh // 2, 2), torch.float32),
            ("mel", (nh, nf), torch.float32),
            ("dct", (nf, ncep), torch.float32),
            ("band", (nf, 2), torch.int32)):
        t = getattr(ops, name)
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{what} operator {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {device}")


def tail_ptrs(ops: Radix2Operators) -> tuple[int, ...]:
    """(cos, sin, we, wo, tw, mel, dct, band) device pointers, in the order
    of the C entry points' trailing table arguments."""
    return tuple(getattr(ops, n).data_ptr()
                 for n in ("cos", "sin", "we", "wo", "tw", "mel", "dct",
                           "band"))


def _device_ok(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    return True


def mfcc_radix2(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
                dft_passes: int = 6, mel_floor: float = 0.0,
                operators: Radix2Operators | None = None) -> torch.Tensor:
    """K5, the counterpart of ``pallas_mfcc.mfcc_pallas_radix2``:
    (..., T) int16 or float -> (..., F, ncep) f32 (int16 stays int16 on the
    wire, any other dtype is cast to f32).  Needs ``float_config_ok`` and an
    even hop, as the JAX kernel does.  A CUDA tensor launches the kernel or
    raises; a CPU tensor takes ``mfcc_radix2_plain``."""
    if not float_config_ok(cfg) or cfg.hop % 2:
        raise ValueError(f"config outside K5's family (even hop): {cfg}")
    check_passes(dft_passes)
    if not _device_ok(audio, "K5"):
        return mfcc_radix2_plain(audio, cfg, dft_passes=dft_passes,
                                 mel_floor=mel_floor, operators=operators)
    ops = operators or default_operators(cfg, audio.device)
    check_operators(ops, cfg, audio.device, "K5")
    x = _as_audio(audio).contiguous()
    lead, T = x.shape[:-1], x.shape[-1]
    n_frames = framing.num_frames(T, cfg.hop, cfg.nfft)
    x = x.reshape(-1, T)
    S = x.shape[0]
    out = torch.empty((S, n_frames, cfg.nceptrums), dtype=torch.float32,
                      device=x.device)
    lib = build.library()
    fn = (lib.mfcc_radix2_i16 if x.dtype == torch.int16
          else lib.mfcc_radix2_f32)
    build.launch(fn, x.device, x.data_ptr(), out.data_ptr(), S, T, n_frames,
                 cfg.hop, cfg.nfft, cfg.nfilters, cfg.nceptrums, dft_passes,
                 *tail_ptrs(ops), float(mel_floor))
    LAUNCHES["K5"] += 1
    return out.reshape(lead + (n_frames, cfg.nceptrums))


def mfcc_frames_float(frames: torch.Tensor, cfg: MFCCConfig = MFCCConfig(),
                      *, dft_passes: int = 6, mel_floor: float = 0.0,
                      operators: Radix2Operators | None = None
                      ) -> torch.Tensor:
    """K5-frames, the counterpart of ``pallas_mfcc.mfcc_pallas_frames_float``:
    (..., F, nfft) pre-emphasized frames of any float dtype (cast to f32)
    -> (..., F, ncep) f32.  A CUDA tensor launches the kernel or raises; a
    CPU tensor takes ``mfcc_frames_float_plain``."""
    if not float_config_ok(cfg):
        raise ValueError(f"config outside K5-frames' family: {cfg}")
    check_passes(dft_passes)
    if frames.dim() < 1 or frames.shape[-1] != cfg.nfft:
        raise ValueError(f"K5-frames takes (..., F, {cfg.nfft}) frames, got "
                         f"{tuple(frames.shape)}")
    if not _device_ok(frames, "K5-frames"):
        return mfcc_frames_float_plain(frames, cfg, dft_passes=dft_passes,
                                       mel_floor=mel_floor,
                                       operators=operators)
    ops = operators or default_operators(cfg, frames.device)
    check_operators(ops, cfg, frames.device, "K5-frames")
    x = frames.to(torch.float32).contiguous()
    lead = x.shape[:-1]
    M = x.numel() // cfg.nfft
    out = torch.empty(lead + (cfg.nceptrums,), dtype=torch.float32,
                      device=x.device)
    fn = build.library().mfcc_frames_float_f32
    build.launch(fn, x.device, x.data_ptr(), out.data_ptr(), M, cfg.nfft,
                 cfg.nfilters, cfg.nceptrums, dft_passes, *tail_ptrs(ops),
                 float(mel_floor))
    LAUNCHES["K5-frames"] += 1
    return out


def mfcc_recomp_t_plain(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(),
                        mel_floor: float = 0.0,
                        operators: fladder.LadderOperators | None = None
                        ) -> torch.Tensor:
    """K6 as plain torch ops: K1's plain version at the config's hop."""
    return fladder.mfcc_float_ladder_plain(_as_audio(audio), cfg, mel_floor,
                                           operators)


def mfcc_recomp_t(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(),
                  mel_floor: float = 0.0,
                  operators: fladder.LadderOperators | None = None
                  ) -> torch.Tensor:
    """K6, the counterpart of ``pallas_mfcc.mfcc_pallas_recomp_t``: the
    float MFCC of (..., T) int16 or float audio at any hop, on K1's kernel
    (FP64 inside, f32 out).  A CUDA tensor launches
    ``mfcc_fladder_{i16,f32}`` or raises; a CPU tensor takes
    ``mfcc_recomp_t_plain``."""
    if not float_config_ok(cfg):
        raise ValueError(f"config outside K6's family: {cfg}")
    if not _device_ok(audio, "K6"):
        return mfcc_recomp_t_plain(audio, cfg, mel_floor, operators)
    ops = operators or fladder.default_operators(cfg, audio.device)
    fladder.check_operators(ops, cfg, audio.device, "K6")
    out = fladder.launch_ladder(_as_audio(audio).contiguous(), cfg,
                                mel_floor, ops)
    LAUNCHES["K6"] += 1
    return out
