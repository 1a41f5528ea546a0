"""Bit-exact fixed-point MFCC pipeline on torch tensors.

The counterpart of ``mfcc_tpu.ops.int_ops``: the RTL's integer arithmetic
(see ``ref/int_ref.py`` for the per-stage derivations) with int32
arithmetic wherever 32-bit wraparound provably preserves the reference's
truncated 16-bit outputs, and int64 only where the datapath genuinely wraps
mod 2^64 (the FilterBank o_regb accumulator, mfcc/core/filterbank.py:77).
It runs on CPU and CUDA tensors alike, and it is the plain version of the
fused INT kernels K2 and K3 (``ops/int_fused.py``).

Exactness argument for int32 in the FFT butterfly: the output keeps only
wrap16((x0 + (sub >> 14)) >> 1); for any k, (sub + k*2^32) >> 14 differs by
k*2^18 which is 0 mod 2^17, and only the sum mod 2^17 survives the final
>>1 + 16-bit truncation.  So natural int32 wraparound is invisible in the
result.  The same argument covers every other int32 stage; the tests
assert element-exact equality with the unbounded-int oracle.

torch's int64 is native on both devices, so nothing here needs an x64
mode.  CUDA has no int64 matrix product, so the filterbank is a
broadcast-multiply-and-sum, chunked over frames to bound its memory.  The
JAX package's x64-free 8-bit-limb MXU filterbank (``filterbank_int32``) is
a TPU device and is not ported.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import FILTERBANK_WIDTH, MFCCConfig
from .. import tables
from .framing import extract_frames, preemphasis_int, wrap_signed

# frames per filterbank chunk: the (chunk, nbins, ntap) int64 product of
# the default config is 256 MiB
FB_CHUNK = 4096


@functools.lru_cache(maxsize=None)
def _curve(nfft: int, precision: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(tables.int_window_curve(nfft, precision),
                           dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _perm(size: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(tables.bit_reverse_permutation(size), device=device)


# ---------------------------------------------------------------------------
# Window (mfcc/core/window.py:84)
# ---------------------------------------------------------------------------

def window_int(frames: torch.Tensor, nfft: int = 512, precision: int = 8,
               width: int = 16) -> torch.Tensor:
    """(x * curve) >> (precision+1), truncated to ``width`` bits."""
    curve = _curve(nfft, precision, frames.device)
    prod = frames.to(torch.int32) * curve            # wraps mod 2^32
    return wrap_signed(prod >> (precision + 1), width)


# ---------------------------------------------------------------------------
# Radix-2 DIT FFT (mfcc/misc/fft.py), int32, stages unrolled
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stage_twiddles(size: int, width: int, device: torch.device):
    """Per-stage twiddle vectors (length 2^s) as int32 tensors."""
    twr, twi = tables.twiddle_table(size, width)
    nstages = int(np.log2(size))
    out = []
    for s in range(nstages):
        stride = 1 << (nstages - 1 - s)
        out.append(tuple(torch.as_tensor(t[::stride][: 1 << s],
                                         dtype=torch.int32, device=device)
                         for t in (twr, twi)))
    return out


def _butterfly(x0r, x0i, x1r, x1i, twr, twi, width: int):
    """The Butterfly datapath (mfcc/misc/fft.py:140-192) in int32."""
    bias = (1 << (width - 3)) - 1          # (1 << bias_width-1) - 1, fft.py:94
    bias_width = width - 2
    m0 = (x1r + x1i) * twr
    m1 = x1i * (twr + twi)
    m2 = x1r * (twr - twi)
    sub1 = (m0 + bias - m1) >> bias_width
    sub2 = (m0 + bias - m2) >> bias_width
    y0r = wrap_signed((x0r + sub1) >> 1, width)
    y0i = wrap_signed((x0i + sub2) >> 1, width)
    y1r = wrap_signed((x0r - sub1) >> 1, width)
    y1i = wrap_signed((x0i - sub2) >> 1, width)
    return y0r, y0i, y1r, y1i


def fft_int(re: torch.Tensor, im: torch.Tensor | None = None,
            width: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """Block FFT over the last axis, (..., size) int32 -> (re, im) int32.

    The bit-reversed load (fft.py:413-418) is a constant gather; each of
    the log2(size) stages is a reshape-split butterfly over the last axis.
    """
    size = re.shape[-1]
    nstages = int(np.log2(size))
    assert 1 << nstages == size
    perm = _perm(size, re.device)
    wr = re.to(torch.int32)[..., perm]
    wi = (torch.zeros_like(wr) if im is None
          else im.to(torch.int32)[..., perm])
    lead = wr.shape[:-1]

    for s, (twr, twi) in enumerate(_stage_twiddles(size, width, re.device)):
        groups = size >> (s + 1)
        v_r = wr.reshape(lead + (groups, 2, 1 << s))
        v_i = wi.reshape(lead + (groups, 2, 1 << s))
        y0r, y0i, y1r, y1i = _butterfly(v_r[..., 0, :], v_i[..., 0, :],
                                        v_r[..., 1, :], v_i[..., 1, :],
                                        twr, twi, width)
        wr = torch.stack([y0r, y1r], dim=-2).reshape(lead + (size,))
        wi = torch.stack([y0i, y1i], dim=-2).reshape(lead + (size,))
    return wr, wi


def fft_stream_int(frames: torch.Tensor, width: int = 16):
    """Real input, first nfft//2 bins (mfcc/core/fft_stream.py:24,28)."""
    re, im = fft_int(frames, None, width)
    half = frames.shape[-1] // 2
    return re[..., :half], im[..., :half]


# ---------------------------------------------------------------------------
# Power spectrum (mfcc/core/pow2.py:33,64)
# ---------------------------------------------------------------------------

def power_int(re: torch.Tensor, im: torch.Tensor, width: int = 16,
              width_output: int = 30) -> torch.Tensor:
    """(r*r + i*i) as a 2*width-bit field, keep the top width_output bits.
    For 16->30: logical shift right by 2 of the mod-2^32 bit pattern.
    torch has no logical shift: an arithmetic shift, then a mask that
    clears the bits it filled with copies of the sign."""
    s = re * re + im * im                      # wraps mod 2^32 in int32
    shift = 2 * width - width_output
    if shift == 0:
        return s
    return (s >> shift) & ((1 << (32 - shift)) - 1)


# ---------------------------------------------------------------------------
# Mel filterbank (mfcc/core/filterbank.py) -- int64
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fb_constants(sample_rate: int, nfft: int, ntap: int, wsize: int,
                  gain: int, width_output: int, width: int):
    points = tables.mel_filter_points(sample_rate, nfft, ntap)
    maxvalrange = int(math.log2(int(points[-1] - points[-3]))) + width + wsize
    shift = maxvalrange - gain - width_output
    W = tables.int_filterbank_matrix(sample_rate, nfft, ntap, wsize)
    return np.array([[int(v) for v in row] for row in W], dtype=np.int64), shift


@functools.lru_cache(maxsize=None)
def _fb_matrix(device: torch.device, *key) -> tuple[torch.Tensor, int]:
    """``_fb_constants(*key)`` with W as an int64 tensor on ``device``."""
    W, shift = _fb_constants(*key)
    return torch.as_tensor(W, device=device), shift


def filterbank_int(power: torch.Tensor, sample_rate: int = 16000,
                   nfft: int = 512, ntap: int = 32, wsize: int = 30,
                   gain: int = 18, width_output: int = 16,
                   width: int = 30) -> torch.Tensor:
    """out[j] = ((power . W[:, j]) >> shift) & (2^width_output - 1) with the
    exact integer weight matrix (tables.int_filterbank_matrix).  The o_regb
    accumulator wraps mod 2^64 (filterbank.py:77): an int64 broadcast
    product and sum, ``FB_CHUNK`` frames at a time."""
    W, shift = _fb_matrix(power.device, sample_rate, nfft, ntap, wsize,
                          gain, width_output, width)
    lead = power.shape[:-1]
    p = power.reshape(-1, power.shape[-1])
    acc = torch.empty((p.shape[0], ntap), dtype=torch.int64,
                      device=power.device)
    for i in range(0, p.shape[0], FB_CHUNK):
        p64 = p[i: i + FB_CHUNK].to(torch.int64)
        acc[i: i + FB_CHUNK] = (p64[:, :, None] * W).sum(dim=-2)
    out = (acc >> shift) & ((1 << width_output) - 1)
    return out.to(torch.int32).reshape(lead + (ntap,))


# ---------------------------------------------------------------------------
# Fixed-point log2 (mfcc/core/log.py) -- int32, fixed iteration count
# ---------------------------------------------------------------------------

def log2fix_int(data: torch.Tensor, width: int = 16,
                width_output: int = 15) -> torch.Tensor:
    """Turner's method, branch-free: clz-style normalize then precision-1
    square-and-compare rounds (the RTL's serial FSM, log.py:57-102, has a
    statically bounded trip count so it unrolls exactly)."""
    precision = width_output - math.ceil(math.log2(width))
    d = data.to(torch.int32)
    d = torch.where(d == 0, 1, d)                     # log.py:123-126
    # shifts = floor(log2(d)) via thresholds (d < 2^width)
    shifts = torch.zeros_like(d)
    for j in range(1, width):
        shifts = shifts + (d >= (1 << j)).to(torch.int32)
    z = (d << precision) >> shifts                    # in [2^p, 2^(p+1))
    res = shifts << precision
    b = 1 << (precision - 1)
    for _ in range(precision - 1):
        c = z * z                                     # < 2^(2p+2) <= 2^24
        hi = (c >> (2 * precision + 1)) & 1
        res = res + hi * b
        z = torch.where(hi == 1, c >> (precision + 1), c >> precision)
        b >>= 1
    return res & ((1 << width_output) - 1)


def log2fixcalc_int(x: torch.Tensor, width: int, precision: int,
                    allow_fraction_input: bool = False) -> torch.Tensor:
    """Branch-free twin of the raw ``Log2FixCalc`` FSM (mfcc/core/log.py:8-102)
    with its SHIFT-LEFT fraction-input mode (log.py:47-55), the counterpart
    of ``mfcc_tpu.ops.int_ops.log2fixcalc_int``.

    ``x`` is the already-shifted register value, >= 1.  In fraction mode,
    inputs in [1, 2^precision) are normalized up, each left shift
    subtracting 2^precision from the width-bit, wrapping result register
    (negative exponents); without it they pass the SHIFT-RIGHT state
    unnormalized, as the RTL does.  Returns the raw width-bit register value
    (unsigned) as int32."""
    assert precision <= 14, "z*z must stay exact in int32"
    d = x.to(torch.int32)
    # floor(log2(d)) via thresholds over the width-bit range
    shifts = torch.zeros_like(d)
    for j in range(1, width):
        shifts = shifts + (d >= (1 << j)).to(torch.int32)
    e = shifts - precision                 # net normalize exponent
    if not allow_fraction_input:
        e = torch.clamp_min(e, 0)
    z = torch.where(e >= 0, d >> torch.clamp_min(e, 0),
                    d << torch.clamp_min(-e, 0))
    res = e * (1 << precision)             # a negative e wraps below
    b = 1 << (precision - 1)
    for _ in range(precision - 1):
        c = z * z
        hi = (c >> (2 * precision + 1)) & 1
        res = res + hi * b
        z = torch.where(hi == 1, c >> (precision + 1), c >> precision)
        b >>= 1
    return res & ((1 << width) - 1)


# ---------------------------------------------------------------------------
# DCT via 4N FFT (mfcc/core/dct_stream.py:29-37)
# ---------------------------------------------------------------------------

def dct_int(x: torch.Tensor, width: int = 16) -> torch.Tensor:
    """buf[2k+1] = x[k], buf[4N-1-2k] = x[k], zeros elsewhere; 4N INT FFT;
    first N real bins.  The scatter is two interleaves."""
    n = x.shape[-1]
    x = x.to(torch.int32)
    z = torch.zeros_like(x)
    first = torch.stack([z, x], dim=-1).reshape(x.shape[:-1] + (2 * n,))
    second = torch.stack([z, x.flip(-1)], dim=-1).reshape(
        x.shape[:-1] + (2 * n,))
    buf = torch.cat([first, second], dim=-1)
    re, _ = fft_int(buf, None, width)
    return re[..., :n]


# ---------------------------------------------------------------------------
# Full INT pipeline (mfcc/core/mfcc.py:90-104)
# ---------------------------------------------------------------------------

def _fb_int32_layout_ok(cfg: MFCCConfig) -> bool:
    """Whether the filterbank's needed bits fit the JAX package's 4-digit
    base-2^23 window (``mfcc_tpu.ops.int_ops.filterbank_int32``; always
    true for the reference config family).  Part of the fused kernels'
    config family (``int_fused.int_config_ok``)."""
    _, shift = _fb_constants(cfg.samplerate, cfg.nfft, cfg.nfilters,
                             cfg.filter_wsize, cfg.filter_gain, 16,
                             cfg.power_width)
    return shift + 16 <= 23 * 3 + 1 and shift // 23 + 1 < 4


def mfcc_int_frames(frames: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                    ) -> torch.Tensor:
    """Fixed-point pipeline on pre-emphasized int frames:
    (..., F, nfft) int32 -> (..., F, nceptrums) int32 (int16-range values).

    The sample datapath honors cfg.width (validated consistent); the
    filterbank output / log2 input width is the reference's architectural
    constant (config.FILTERBANK_WIDTH, mfcc/core/mfcc.py:69,82)."""
    return mfcc_int_from_power(power_frames_int(frames, cfg), cfg)


def power_frames_int(frames: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                     ) -> torch.Tensor:
    """The stages up to the power, on pre-emphasized int frames:
    (..., F, nfft) int32 -> (..., F, nfft/2) int32 (window, FFT, power)."""
    cfg.validate_int()
    win = window_int(frames, cfg.nfft, cfg.window_precision, cfg.width)
    re, im = fft_stream_int(win, cfg.width)
    return power_int(re, im, cfg.width, cfg.power_width)


def mfcc_int_from_power(power: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                        ) -> torch.Tensor:
    """The stages after the power: (..., F, nfft/2) int32 ->
    (..., F, nceptrums) int32 (filterbank, log2, DCT)."""
    mel = filterbank_int(power, cfg.samplerate, cfg.nfft, cfg.nfilters,
                         cfg.filter_wsize, cfg.filter_gain, FILTERBANK_WIDTH,
                         cfg.power_width)
    logmel = log2fix_int(mel, FILTERBANK_WIDTH, cfg.log_width_output)
    cep = dct_int(logmel, cfg.width)
    return cep[..., : cfg.nceptrums]


def mfcc_int_batch(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                   ) -> torch.Tensor:
    """Full INT pipeline on raw int16-range signals:
    (..., T) int32 -> (..., F, nceptrums) int32."""
    emph = preemphasis_int(audio.to(torch.int32), width=cfg.width)
    frames = extract_frames(emph, cfg.nfft, cfg.hop, windowlen=cfg.windowlen)
    return mfcc_int_frames(frames, cfg)
