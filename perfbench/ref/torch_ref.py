"""The plain reference in vectorised torch: the float pipeline in float64 and
the INT pipeline in int64, stage for stage as ``float_ref`` and ``int_ref``
compute them, on any device and in blocks of frames so that it fits beside
what the run keeps.  Tables come from this folder's ``tables``, worked out
again from the configuration.

Each pipeline also has its control, the same code one precision lower:

* float: every product's operands rounded to TF32 (10 mantissa bits, the
  rounding the card's TF32 units apply) and everything in float32; the
  configuration states float32 with TF32 off, in which a float64 oracle is
  met within 5e-4;
* INT: the mel filterbank accumulated in float32, as a float GEMM would do
  it, in place of the exact 64-bit integer sums the RTL's datapath gives.

Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import tables
from .config import MFCCConfig
from .float_ref import EMPHASIS_COEFF

BLOCK_FRAMES = 1 << 15     # frames a block: ~0.13 GB per (block, 512) int64


# -- float ----------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def float_operators(cfg: MFCCConfig, dtype, device) -> dict:
    """The windowed real DFT (scaled 1/nfft), the mel matrix and the
    DCT-II basis of ``cfg`` in ``dtype``."""
    nfft = cfg.nfft
    w = tables.float_window(nfft)
    n = np.arange(nfft)[:, None]
    k = np.arange(nfft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / nfft
    dft = np.concatenate([w[:, None] * np.cos(ang),
                          -w[:, None] * np.sin(ang)], axis=1) / nfft
    mel = tables.float_mel_matrix(cfg.samplerate, nfft, cfg.nfilters)
    dct = tables.dct2_ortho_matrix(cfg.nfilters)[:, : cfg.nceptrums]
    return {name: torch.as_tensor(a, dtype=dtype, device=device)
            for name, a in (("dft", dft), ("mel", mel), ("dct", dct))}


def _float_frames(frames: torch.Tensor, ops: dict, control: bool
                  ) -> torch.Tensor:
    """(M, nfft) emphasised frames -> (M, ncep) cepstra."""
    mm = ((lambda a, b: tf32(a) @ tf32(b)) if control
          else (lambda a, b: a @ b))
    spec = mm(frames, ops["dft"])
    nb = spec.shape[-1] // 2
    power = spec[:, :nb] ** 2 + spec[:, nb:] ** 2
    logmel = torch.log2(mm(power, ops["mel"]))
    return mm(logmel, ops["dct"])


def mfcc_float(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
               prev: torch.Tensor | None = None, control: bool = False
               ) -> torch.Tensor:
    """(S, T) samples -> (S, F, ncep) cepstra of ``float_ref.mfcc_float``,
    float64 (float32 under ``control``).  ``prev`` (S,) is the raw sample
    before each row's first (0 by default, the oracle's y[0] = x[0]), so a
    stretch cut from the middle of a stream is emphasised as the whole
    stream would be."""
    dtype = torch.float32 if control else torch.float64
    x = audio.to(dtype)
    S, T = x.shape
    p = (torch.zeros(S, dtype=dtype, device=x.device) if prev is None
         else prev.to(dtype))
    emph = x - EMPHASIS_COEFF * torch.cat([p[:, None], x[:, :-1]], dim=1)
    frames = emph.unfold(1, cfg.nfft, cfg.hop)            # (S, F, nfft)
    F = frames.shape[1]
    ops = float_operators(cfg, dtype, x.device)
    out = torch.empty((S, F, cfg.nceptrums), dtype=dtype, device=x.device)
    rows = max(1, BLOCK_FRAMES // max(F, 1))
    for s in range(0, S, rows):
        blk = frames[s: s + rows].reshape(-1, cfg.nfft)
        out[s: s + rows] = _float_frames(blk, ops, control).reshape(
            -1, F, cfg.nceptrums)
    return out


# -- INT ------------------------------------------------------------------------

def wrap_signed(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Truncate to ``bits`` and sign-extend."""
    sign = 1 << (bits - 1)
    return ((v & ((1 << bits) - 1)) ^ sign) - sign


class IntTables:
    """The INT pipeline's tables of ``cfg`` as int64 tensors on a device."""

    def __init__(self, cfg: MFCCConfig, device):
        cfg.validate_int()
        self.cfg = cfg
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                         device=device)
        self.curve = as_t(tables.int_window_curve(cfg.nfft,
                                                  cfg.window_precision))
        self.fft = {n: self._fft_tables(n, cfg.width, as_t)
                    for n in (cfg.nfft, 4 * cfg.nfilters)}
        W = tables.int_filterbank_matrix(cfg.samplerate, cfg.nfft,
                                         cfg.nfilters, cfg.filter_wsize)
        self.fbw = as_t(W.astype(np.int64))
        nz = W.astype(np.int64) != 0
        self.bands = [(int(np.argmax(nz[:, j])),
                       len(nz) - int(np.argmax(nz[::-1, j])))
                      for j in range(cfg.nfilters)]
        points = tables.mel_filter_points(cfg.samplerate, cfg.nfft,
                                          cfg.nfilters)
        maxvalrange = (int(math.log2(int(points[-1] - points[-3])))
                       + cfg.power_width + cfg.filter_wsize)
        self.fb_shift = maxvalrange - cfg.filter_gain - 16
        pos_a, pos_b = tables.dct_fill_layout(cfg.nfilters)
        self.dct_pos = as_t(pos_a), as_t(pos_b)

    @staticmethod
    def _fft_tables(size: int, width: int, as_t):
        twr, twi = tables.twiddle_table(size, width)
        plan = [(as_t(i0), as_t(i1), as_t(twr[tw]), as_t(twi[tw]))
                for i0, i1, tw in tables.dit_stage_plan(size)]
        return as_t(tables.bit_reverse_permutation(size)), plan


def fft_int(re: torch.Tensor, fft_tables, width: int):
    """The RTL's radix-2 DIT FFT (``int_ref.fft_int``) on real int64 rows
    (..., size)."""
    perm, plan = fft_tables
    wr = re[..., perm]
    wi = torch.zeros_like(wr)
    bias_width = width - 2
    bias = (1 << (bias_width - 1)) - 1
    for i0, i1, twr, twi in plan:
        x0r, x0i, x1r, x1i = wr[..., i0], wi[..., i0], wr[..., i1], wi[..., i1]
        m0 = (x1r + x1i) * twr
        sub1 = (m0 + bias - x1i * (twr + twi)) >> bias_width
        sub2 = (m0 + bias - x1r * (twr - twi)) >> bias_width
        wr[..., i0] = wrap_signed((x0r + sub1) >> 1, width)
        wi[..., i0] = wrap_signed((x0i + sub2) >> 1, width)
        wr[..., i1] = wrap_signed((x0r - sub1) >> 1, width)
        wi[..., i1] = wrap_signed((x0i - sub2) >> 1, width)
    return wr, wi


def log2fix(data: torch.Tensor, width: int = 16, width_output: int = 15
            ) -> torch.Tensor:
    """``int_ref.log2fix_int``, elementwise on int64."""
    p = width_output - math.ceil(math.log2(width))
    x = torch.where(data == 0, torch.ones_like(data), data) << p
    res = torch.zeros_like(x)
    while True:
        big = (x >> (p + 1)) != 0
        if not bool(big.any()):
            break
        x = torch.where(big, x >> 1, x)
        res = res + (big.to(torch.int64) << p)
    z = x
    b = 1 << (p - 1)
    for _ in range(p - 1):
        c = z * z
        bit = (c >> (2 * p + 1)) & 1
        z = torch.where(bit == 1, c >> (p + 1), c >> p)
        res = res + bit * b
        b >>= 1
    return res & ((1 << width_output) - 1)


def _filterbank(power: torch.Tensor, t: IntTables, control: bool
                ) -> torch.Tensor:
    """(M, nbins) power -> (M, nfilters) FilterBank outputs: the low 16 bits
    of (power @ W) >> shift, the sums mod 2^64 (the bits kept lie below
    bit 64), or in float32 under ``control``."""
    mask = (1 << 16) - 1
    out = torch.empty((power.shape[0], len(t.bands)), dtype=torch.int64,
                      device=power.device)
    for j, (lo, hi) in enumerate(t.bands):
        if control:
            acc = (power[:, lo:hi].to(torch.float32)
                   * t.fbw[lo:hi, j].to(torch.float32)).sum(-1)
            q = torch.floor(acc.to(torch.float64) / 2.0 ** t.fb_shift)
            out[:, j] = (q - 65536.0 * torch.floor(q / 65536.0)).to(
                torch.int64)
        else:
            acc = (power[:, lo:hi] * t.fbw[lo:hi, j]).sum(-1)
            out[:, j] = (acc >> t.fb_shift) & mask
    return out


def _int_frames(frames: torch.Tensor, t: IntTables, control: bool
                ) -> torch.Tensor:
    """(M, nfft) emphasised int64 frames -> (M, ncep) cepstra."""
    cfg = t.cfg
    win = wrap_signed((frames * t.curve) >> (cfg.window_precision + 1),
                      cfg.width)
    re, im = fft_int(win, t.fft[cfg.nfft], cfg.width)
    half = cfg.nfft // 2
    re, im = re[:, :half], im[:, :half]
    s = (re * re + im * im) & ((1 << (2 * cfg.width)) - 1)
    power = s >> (2 * cfg.width - cfg.power_width)
    logmel = log2fix(_filterbank(power, t, control), 16,
                     cfg.log_width_output)
    buf = torch.zeros((frames.shape[0], 4 * cfg.nfilters),
                      dtype=torch.int64, device=frames.device)
    buf[:, t.dct_pos[0]] = logmel
    buf[:, t.dct_pos[1]] = logmel
    cep, _ = fft_int(buf, t.fft[4 * cfg.nfilters], cfg.width)
    return cep[:, : cfg.nceptrums]


def mfcc_int(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(), *,
             prev: torch.Tensor | None = None, control: bool = False,
             int_tables: IntTables | None = None) -> torch.Tensor:
    """(S, T) int16-range samples -> (S, F, ncep) int64 cepstra of
    ``int_ref.mfcc_int`` for each row; ``prev`` as for ``mfcc_float``."""
    t = int_tables or IntTables(cfg, audio.device)
    x = audio.to(torch.int64)
    p = (torch.zeros_like(x[:, 0]) if prev is None
         else prev.to(torch.int64))
    prev = torch.cat([p[:, None], x[:, :-1]], dim=1)
    emph = wrap_signed(x + (prev >> 5) - prev, cfg.width)
    frames = emph.unfold(1, cfg.windowlen, cfg.hop)
    if cfg.windowlen < cfg.nfft:
        frames = torch.nn.functional.pad(frames,
                                         (0, cfg.nfft - cfg.windowlen))
    S, F = frames.shape[:2]
    out = torch.empty((S, F, cfg.nceptrums), dtype=torch.int64,
                      device=x.device)
    rows = max(1, BLOCK_FRAMES // max(F, 1))
    for s in range(0, S, rows):
        blk = frames[s: s + rows].reshape(-1, cfg.nfft)
        out[s: s + rows] = _int_frames(blk, t, control).reshape(
            -1, F, cfg.nceptrums)
    return out
