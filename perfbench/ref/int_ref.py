"""Exact fixed-point reference pipeline (numpy + Python ints).

A bit-for-bit port of the RTL's integer arithmetic.  Every function documents
the reference construct it replicates (file:line into the reference RTL
sources).  This oracle is deliberately written with unbounded Python ints /
int64 and explicit masking so there is no question of overflow semantics.

The benchmark's frozen copy of ``mfcc_tpu_torch/ref/int_ref.py``, code for
code, on this folder's own ``config`` and ``tables``: it imports nothing of
the program.  ``torch_ref.py`` is its vectorised form, tested equal to it.
"""

from __future__ import annotations

import numpy as np

from .config import MFCCConfig
from . import tables


# ---------------------------------------------------------------------------
# Bit helpers
# ---------------------------------------------------------------------------

def wrap_signed(v, bits: int):
    """Truncate to ``bits`` and sign-extend (nMigen signed signal assignment)."""
    v = np.asarray(v, dtype=np.int64)
    mask = (1 << bits) - 1
    v = v & mask
    sign = 1 << (bits - 1)
    return (v ^ sign) - sign


# ---------------------------------------------------------------------------
# Stage 1: pre-emphasis (mfcc/core/preemph.py:20-27)
# ---------------------------------------------------------------------------

def preemphasis_int(x: np.ndarray, width: int = 16) -> np.ndarray:
    """y[t] = wrap16(x[t] + (x[t-1] >> 5) - x[t-1]); the previous-sample
    register resets to 0 so y[0] = x[0]."""
    x = np.asarray(x, dtype=np.int64)
    prev = np.concatenate([[0], x[:-1]])
    return wrap_signed(x + (prev >> 5) - prev, width)


# ---------------------------------------------------------------------------
# Stage 2: framing (mfcc/core/frame.py:49-155)
# ---------------------------------------------------------------------------

def frame_int(x: np.ndarray, nfft: int = 512, hop: int = 170,
              windowlen: int | None = None) -> np.ndarray:
    """Overlapped frames out of the ring buffer; positions >= windowlen are
    zero-padded (frame.py:77,120).  The core uses windowlen == nfft so padding
    is inert (mfcc/core/mfcc.py:41-44)."""
    if windowlen is None:
        windowlen = nfft
    x = np.asarray(x, dtype=np.int64)
    n = (len(x) - windowlen) // hop + 1
    frames = np.zeros((n, nfft), dtype=np.int64)
    for i in range(n):
        frames[i, :windowlen] = x[i * hop: i * hop + windowlen]
    return frames


# ---------------------------------------------------------------------------
# Stage 3: Hamming window (mfcc/core/window.py:84: keep top ``width`` bits)
# ---------------------------------------------------------------------------

def window_int(frames: np.ndarray, nfft: int = 512, precision: int = 8,
               width: int = 16) -> np.ndarray:
    """out = (x * curve) >> (precision+1), where curve is the reconstructed
    integer window (tables.int_window_curve).  The multiplier result is
    width+precision+1 bits; source.data = c[-width:] keeps the top width bits
    = arithmetic shift right by precision+1 (window.py:84)."""
    curve = tables.int_window_curve(nfft, precision)
    prod = np.asarray(frames, dtype=np.int64) * curve
    return wrap_signed(prod >> (precision + 1), width)


# ---------------------------------------------------------------------------
# Stage 4: radix-2 DIT FFT (mfcc/misc/fft.py)
# ---------------------------------------------------------------------------

def butterfly_int(x0r, x0i, x1r, x1i, twr, twi, width: int = 16):
    """One DIT butterfly with the reference's exact arithmetic
    (mfcc/misc/fft.py:140-192, instantiated with bias_width=m_width-2=14,
    scale_bit=1 at fft.py:380):

      m0 = (Re x1 + Im x1) * Re w            (fft.py:152,159)
      m1 = Im x1 * (Re w + Im w)             (fft.py:166,173)
      m2 = Re x1 * (Re w - Im w)             (fft.py:167,174)
      sub1 = m0 + bias - m1 ; sub2 = m0 + bias - m2   (fft.py:165,179-180)
      y0 = wrap16((x0 + (sub >> 14)) >> 1)   (fft.py:188-191)
      y1 = wrap16((x0 - (sub >> 14)) >> 1)

    with bias = (1 << 13) - 1 (fft.py:94).  All shifts are floor (bit-slice)
    shifts; final truncation to 16 bits wraps.
    """
    bias_width = width - 2
    bias = (1 << (bias_width - 1)) - 1
    x0r = np.asarray(x0r, dtype=np.int64)
    x0i = np.asarray(x0i, dtype=np.int64)
    x1r = np.asarray(x1r, dtype=np.int64)
    x1i = np.asarray(x1i, dtype=np.int64)
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


def fft_int(re: np.ndarray, im: np.ndarray | None = None, width: int = 16):
    """Block FFT of ``size = len(re)`` with bit-reversed load
    (fft.py:413-418,448-450) and the Scheduler's standard DIT schedule
    (tables.dit_stage_plan).  Output approximates fft(x)/size.
    Accepts a trailing batch: shape (..., size)."""
    re = np.asarray(re, dtype=np.int64)
    if im is None:
        im = np.zeros_like(re)
    im = np.asarray(im, dtype=np.int64)
    size = re.shape[-1]
    perm = tables.bit_reverse_permutation(size)
    wr = re[..., perm].copy()
    wi = im[..., perm].copy()
    twr, twi = tables.twiddle_table(size, width)
    for (i0, i1, tw) in tables.dit_stage_plan(size):
        y0r, y0i, y1r, y1i = butterfly_int(
            wr[..., i0], wi[..., i0], wr[..., i1], wi[..., i1],
            twr[tw], twi[tw], width)
        wr[..., i0], wi[..., i0] = y0r, y0i
        wr[..., i1], wi[..., i1] = y1r, y1i
    return wr, wi


def fft_stream_int(frames: np.ndarray, width: int = 16):
    """FftStream: real input, read back only the first nfft//2 bins
    (mfcc/core/fft_stream.py:24,28)."""
    re, im = fft_int(frames, None, width)
    half = frames.shape[-1] // 2
    return re[..., :half], im[..., :half]


# ---------------------------------------------------------------------------
# Stage 5: power spectrum (mfcc/core/pow2.py)
# ---------------------------------------------------------------------------

def power_int(re: np.ndarray, im: np.ndarray, width: int = 16,
              width_output: int = 30) -> np.ndarray:
    """|X|^2 = r*r + i*i, sum truncated to 2*width bits, output keeps the top
    width_output bits: data = sum[-width_output:] (pow2.py:33,64) ==
    (sum mod 2^32) >> 2 for the 16->30 instantiation (mfcc.py:60-62)."""
    re = np.asarray(re, dtype=np.int64)
    im = np.asarray(im, dtype=np.int64)
    s = (re * re + im * im) & ((1 << (2 * width)) - 1)
    return s >> (2 * width - width_output)


# ---------------------------------------------------------------------------
# Stage 6: mel filterbank (mfcc/core/filterbank.py)
# ---------------------------------------------------------------------------

def filterbank_int_sequential(power: np.ndarray, sample_rate: int = 16000,
                              nfft: int = 512, ntap: int = 32,
                              wsize: int = 30, gain: int = 18,
                              width_output: int = 16,
                              width: int = 30) -> np.ndarray:
    """Direct sequential simulation of the FilterBank datapath
    (filterbank.py:90-142) over one frame of nfft//2 power samples.
    Used to cross-check the closed-form weight matrix.  ``width`` is the
    input data width (= PowerSpectrum width_output, mfcc.py:61,68)."""
    points = tables.mel_filter_points(sample_rate, nfft, ntap)
    steps = tables.mel_filter_steps(points, wsize)
    # o_regb register width (filterbank.py:77): wraps mod 2^maxvalrange
    import math
    maxvalrange = int(math.log2(int(points[-1] - points[-3]))) + width + wsize
    regmask = (1 << maxvalrange) - 1

    mask = (1 << wsize) - 1
    nbins = nfft // 2
    assert power.shape[-1] == nbins
    out = []
    i_acc = 0
    filter_adr = 0
    o_rega = 0
    o_regb = 0
    for k in range(nbins):
        d = int(power[k])
        last = (k == nbins - 1)
        w = (i_acc >> wsize) & mask
        highest = (w == mask)
        if highest or last:
            if filter_adr != 0:
                out.append((o_regb >> (maxvalrange - gain - width_output))
                           & ((1 << width_output) - 1))
            o_regb = (o_rega + (d << wsize)) & regmask
            o_rega = 0
            filter_adr = 0 if last else filter_adr + 1
            i_acc = 0
        else:
            a = d * w
            o_rega += a
            o_regb = (o_regb + (d << wsize) - a) & regmask
            i_acc += int(steps[filter_adr])
    return np.array(out, dtype=np.int64)


def filterbank_int(power: np.ndarray, sample_rate: int = 16000,
                   nfft: int = 512, ntap: int = 32, wsize: int = 30,
                   gain: int = 18, width_output: int = 16,
                   width: int = 30) -> np.ndarray:
    """Closed-form: out[j] = ((power @ W)[j] >> shift) & mask with the exact
    integer weight matrix (tables.int_filterbank_matrix).  Batched over
    leading axes.  Equivalent to the sequential datapath; asserted in tests.
    ``width`` = input data width (= PowerSpectrum width_output)."""
    import math
    points = tables.mel_filter_points(sample_rate, nfft, ntap)
    maxvalrange = int(math.log2(int(points[-1] - points[-3]))) + width + wsize
    shift = maxvalrange - gain - width_output
    W = tables.int_filterbank_matrix(sample_rate, nfft, ntap, wsize)
    acc = np.asarray(power, dtype=object) @ W
    mask = (1 << width_output) - 1
    vec = np.vectorize(lambda v: (int(v) >> shift) & mask, otypes=[np.int64])
    return vec(acc)


# ---------------------------------------------------------------------------
# Stage 7: fixed-point log2 (mfcc/core/log.py)
# ---------------------------------------------------------------------------

def log2fix_int(data: np.ndarray, width: int = 16, width_output: int = 15
                ) -> np.ndarray:
    """Clay S. Turner's iterative fixed-point log2 (log.py:57-102):

    * zero input clamps to 1 (log.py:123-126);
    * x = data << precision, normalized into [2^p, 2^(p+1)) by right shifts,
      each adding 2^p to the result (integer part);
    * ``precision-1`` square-and-compare iterations emit fraction bits
      b = 2^(p-1) .. 2^1 (the loop stops at cnt==0 so the LSB is never set,
      log.py:86-102);
    * result truncated to width_output bits (log.py:131).

    For Log2Fix(16, 15): precision = 11, output is Q4.11 with a zero LSB.
    """
    import math
    precision = width_output - math.ceil(math.log2(width))
    data = np.atleast_1d(np.asarray(data, dtype=np.int64))
    out = np.zeros(data.shape, dtype=np.int64)
    flat_in = data.reshape(-1)
    flat_out = out.reshape(-1)
    for idx in range(flat_in.size):
        d = int(flat_in[idx])
        x = (d if d != 0 else 1) << precision
        res = 0
        while x >> (precision + 1):
            x >>= 1
            res += 1 << precision
        z = x
        b = 1 << (precision - 1)
        for _ in range(precision - 1):
            c = z * z
            if c >> (2 * precision + 1) & 1:
                z = c >> (precision + 1)
                res += b
            else:
                z = c >> precision
            b >>= 1
        flat_out[idx] = res & ((1 << width_output) - 1)
    return out


def log2fixcalc_seq(x: int, width: int, precision: int,
                    allow_fraction_input: bool = False) -> int:
    """Literal sequential simulation of the Log2FixCalc FSM states
    (mfcc/core/log.py:28-102): SHIFT-LEFT (fraction mode, log.py:47-55),
    SHIFT-RIGHT, then precision-1 square-and-compare rounds.  All register
    updates wrap mod 2^width like the RTL's width-bit signals."""
    x = int(x)
    assert x >= 1, "the FSM never leaves SHIFT-LEFT on 0"
    mask = (1 << width) - 1
    res = 0
    if allow_fraction_input:
        while x < (1 << precision):             # log.py:48
            x = (x << 1) & mask                 # Cat(Const(0,1), x)
            res = (res - (1 << precision)) & mask
    while x >> (precision + 1):                 # log.py:58
        x >>= 1
        res = (res + (1 << precision)) & mask
    z = x
    b = 1 << (precision - 1)
    for _ in range(precision - 1):              # cnt = precision-1 .. 1
        c = z * z
        if (c >> (2 * precision + 1)) & 1:      # log.py:92
            z = c >> (precision + 1)
            res = (res + b) & mask
        else:
            z = c >> precision
        b >>= 1
    return res


# ---------------------------------------------------------------------------
# Stage 8: DCT via 4N FFT (mfcc/core/dct_stream.py)
# ---------------------------------------------------------------------------

def dct_int(x: np.ndarray, width: int = 16) -> np.ndarray:
    """DCT-II via a 4N-point INT FFT: input scattered to buf[2k+1] = x[k],
    buf[4N-1-2k] = x[k], zeros elsewhere (dct_stream.py:29-34); output is the
    first N real bins (dct_stream.py:36-37)."""
    x = np.asarray(x, dtype=np.int64)
    n = x.shape[-1]
    pos_a, pos_b = tables.dct_fill_layout(n)
    buf = np.zeros(x.shape[:-1] + (4 * n,), dtype=np.int64)
    buf[..., pos_a] = x
    buf[..., pos_b] = x
    re, _ = fft_int(buf, None, width)
    return re[..., :n]


# ---------------------------------------------------------------------------
# Full pipeline (mfcc/core/mfcc.py:90-104)
# ---------------------------------------------------------------------------

def mfcc_int(audio: np.ndarray, cfg: MFCCConfig = MFCCConfig(),
             return_intermediates: bool = False):
    """Complete fixed-point pipeline on a 1-D int16 signal; returns the
    (nframes, nceptrums) int16-range cepstra exactly as the RTL streams them
    out (Discard keeps [0, nceptrums), mfcc/core/mfcc.py:87)."""
    cfg.validate_int()
    emph = preemphasis_int(audio, cfg.width)
    frames = frame_int(emph, cfg.nfft, cfg.hop, cfg.windowlen)
    win = window_int(frames, cfg.nfft, cfg.window_precision, cfg.width)
    re, im = fft_stream_int(win, cfg.width)
    power = power_int(re, im, cfg.width, cfg.power_width)
    mel = np.stack([
        filterbank_int(power[i], cfg.samplerate, cfg.nfft, cfg.nfilters,
                       cfg.filter_wsize, cfg.filter_gain,
                       width=cfg.power_width)
        for i in range(power.shape[0])])
    logmel = log2fix_int(mel, 16, cfg.log_width_output)
    cep = dct_int(logmel, cfg.width)
    out = cep[:, : cfg.nceptrums]
    if return_intermediates:
        return out, dict(emph=emph, frames=frames, win=win, fft_re=re,
                         fft_im=im, power=power, mel=mel, logmel=logmel,
                         cep=cep)
    return out
