"""Constant tables (numpy/scipy).

A copy of ``mfcc_tpu.tables``, function for function, so that the outputs
are bit-identical.  The float path's: the periodic Hamming window, the
triangular mel filterbank, the orthonormal DCT-II basis and the windowed
real-DFT operator (float64; callers cast to their working dtype).  The INT
path's: the bit-reversed load, the integer window curve the RTL rebuilds
from its quarter LUT, the FFT twiddle ROM, the DIT stage plan, the exact
integer filterbank matrix and the DCT fill layout (int64 or Python ints).
The ``lru_cache`` keys are the explicit arguments only.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.signal import get_window


def float_window(nfft: int) -> np.ndarray:
    """Periodic ('fftbins') Hamming window, the float-path window
    (notebook MFCC-INT.ipynb cell 4; mfcc/core/window.py:24)."""
    return get_window("hamm", nfft, fftbins=True)


def freq_to_mel(freq):
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def mel_to_freq(mels):
    return 700.0 * (10.0 ** (np.asarray(mels, dtype=np.float64) / 2595.0) - 1.0)


def mel_filter_points(sample_rate: int, nfft: int, ntap: int) -> np.ndarray:
    """Integer mel band edges: floor((nfft+1)/sr * mel_spaced_freqs)
    (mfcc/core/filterbank.py:15-20).  ntap+2 points."""
    fmin_mel = freq_to_mel(0.0)
    fmax_mel = freq_to_mel(sample_rate / 2.0)
    mels = np.linspace(fmin_mel, fmax_mel, num=ntap + 2)
    freqs = mel_to_freq(mels)
    return np.floor((nfft + 1) / sample_rate * freqs).astype(np.int64)


def float_mel_matrix(sample_rate: int = 16000, nfft: int = 512,
                     ntap: int = 32) -> np.ndarray:
    """Float triangular mel filter matrix, (nfft//2+1, ntap), column-major
    filters exactly as notebook get_filters (MFCC-INT.ipynb cell 7); area
    normalization removed on purpose (MFCC.ipynb cell 33 comments it out)."""
    points = mel_filter_points(sample_rate, nfft, ntap)
    nbins = nfft // 2 + 1
    filters = np.zeros((ntap, nbins), dtype=np.float64)
    for n in range(ntap):
        filters[n, points[n]: points[n + 1]] = np.linspace(
            0, 1, points[n + 1] - points[n])
        filters[n, points[n + 1]: points[n + 2]] = np.linspace(
            1, 0, points[n + 2] - points[n + 1])
    return filters.T.copy()


def dct2_ortho_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis, (n, n): out = x @ M equals
    scipy.fft.dct(x, type=2, norm='ortho') (MFCC-INT.ipynb cell 10)."""
    k = np.arange(n)[None, :]
    i = np.arange(n)[:, None]
    M = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    M[:, 0] = 1.0 / np.sqrt(n)
    return M


def windowed_rdft_matrix(nfft: int, scale: float | None = None,
                         window: np.ndarray | None = None):
    """Real-DFT-as-matmul operators with the Hamming window precomposed:

        re = frames @ C ; im = frames @ S
        C[n, k] = w[n] * cos(2*pi*n*k/nfft) * scale
        S[n, k] = -w[n] * sin(2*pi*n*k/nfft) * scale

    so that re + 1j*im == fft(frames * w)[..., :nfft//2+1] * scale.  The
    notebook pipeline scales by 1/nfft (MFCC-INT.ipynb cell 5).  ``window``
    replaces ``float_window(nfft)`` (e.g. a table loaded from elsewhere).
    """
    if scale is None:
        scale = 1.0 / nfft
    nbins = nfft // 2 + 1
    w = (float_window(nfft) if window is None
         else np.asarray(window, dtype=np.float64))
    n = np.arange(nfft)[:, None]
    k = np.arange(nbins)[None, :]
    ang = 2.0 * np.pi * n * k / nfft
    C = (w[:, None] * np.cos(ang)) * scale
    S = (-w[:, None] * np.sin(ang)) * scale
    return C, S


# ---------------------------------------------------------------------------
# Fixed-point (INT path) tables
# ---------------------------------------------------------------------------

def bit_reverse_permutation(n: int) -> np.ndarray:
    """Index permutation such that ``work[i] = x[perm[i]]`` reproduces the
    FFT core's bit-reversed load (mfcc/misc/fft.py:413-418: the INIT state
    stores input word ``addr`` at memory address ``bitrev(addr)``)."""
    bits = int(np.log2(n))
    assert 1 << bits == n
    perm = np.zeros(n, dtype=np.int64)
    for i in range(n):
        r = 0
        for b in range(bits):
            r |= ((i >> b) & 1) << (bits - 1 - b)
        perm[r] = i
    return perm


def hamming_lut(nfft: int, precision: int):
    """The quarter-wave LUT and offsets, exactly as WindowHamming.calc_coeffs
    (mfcc/core/window.py:22-43).  Returns (mem, off_fst, off_lst)."""
    maxheight = 2 ** (precision + 1) - 1
    window = get_window("hamm", nfft, fftbins=True)
    winfull = (window * maxheight).astype(int)
    mem = np.copy(winfull[: nfft // 4][1::2])
    off_fst = int(mem[0])
    mem = mem - off_fst
    assert mem.max() < 2 ** precision
    off_lst = int(2 * (winfull[nfft // 4] - off_fst))
    return mem.astype(np.int64), off_fst, off_lst


@functools.lru_cache(maxsize=None)
def int_window_curve(nfft: int = 512, precision: int = 8) -> np.ndarray:
    """The full (precision+1)-bit integer window curve the RTL reconstructs at
    runtime from the quarter LUT via horizontal/vertical symmetry and linear
    interpolation (mfcc/core/window.py:94-115).

    This is a faithful sequential simulation of that datapath, including the
    ``point_r`` register seeded at 0 (so curve[0] averages P[0] with 0).
    """
    mem, off_fst, off_lst = hamming_lut(nfft, precision)
    nbits = int(np.log2(nfft))
    addr_bits = nbits - 3  # bits [1:-2] of the counter

    curve = np.zeros(nfft, dtype=np.int64)
    point_r = 0
    for count in range(nfft):
        bit_msb = (count >> (nbits - 1)) & 1
        bit_dir = (count >> (nbits - 2)) & 1
        bits_addr = (count >> 1) & ((1 << addr_bits) - 1)
        bit_odd = count & 1
        addr = (~bits_addr & ((1 << addr_bits) - 1)) if bit_dir else bits_addr
        point = (off_lst - int(mem[addr])) if (bit_msb ^ bit_dir) else int(mem[addr])
        if bit_odd:
            curve[count] = off_fst + point
            point_r = point
        else:
            curve[count] = off_fst + ((point + point_r) >> 1)
    return curve


# ---------------------------------------------------------------------------
# FFT twiddles (INT)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def twiddle_table(size: int, width: int = 16, invert: bool = False):
    """Full half-circle twiddle table (size//2 complex entries) exactly as the
    TwiddleROM quarter-circle store + symmetry decoder produce it
    (mfcc/misc/fft.py:29-59).

    Sign is applied AFTER rounding, and np.round (round-half-to-even) is used,
    matching the ROM init (fft.py:31-36).
    Returns (re, im) int64 arrays of length size//2.
    """
    quarter = int(size // 4)
    p = np.linspace(start=0, stop=np.pi / 2, num=quarter, endpoint=False)
    vals = np.round((1 << (width - 2)) * np.exp(-1j * p))
    q_re = vals.real.astype(np.int64)   # stored "real" words
    q_im = vals.imag.astype(np.int64)   # stored "imag" words (negative)

    re = np.zeros(size // 2, dtype=np.int64)
    im = np.zeros(size // 2, dtype=np.int64)
    # First quarter (sel=0): re = stored real, im = stored imag (fft.py:48,59)
    re[:quarter] = q_re
    im[:quarter] = q_im if not invert else -q_im
    # Second quarter (sel=1): re = stored imag, im = -stored real (fft.py:52-57)
    re[quarter:] = q_im
    im[quarter:] = -q_re if not invert else q_re
    return re, im


def dit_stage_plan(size: int):
    """Static (x0 index, x1 index, twiddle index) plan per DIT stage.

    Derived from the Scheduler's iteration space: for stage ``s`` the tap ``t``
    pairs elements (g*2^(s+1)+j, +2^s) with g=t>>s, j=t&(2^s-1) and twiddle
    address (t mod 2^s) * 2^(log2(size)-1-s) (mfcc/misc/fft.py:240-314, the
    XOR-shuffled 3-bank addressing and the bit-reversed twiddle stride both
    reduce to this standard radix-2 DIT schedule).
    Returns list of (idx0, idx1, tw_idx) int64 arrays, one per stage.
    """
    nstages = int(np.log2(size))
    half = size // 2
    plan = []
    t = np.arange(half, dtype=np.int64)
    for s in range(nstages):
        g = t >> s
        j = t & ((1 << s) - 1)
        i0 = (g << (s + 1)) + j
        i1 = i0 + (1 << s)
        tw = j << (nstages - 1 - s)
        plan.append((i0, i1, tw))
    return plan


def mel_filter_steps(points: np.ndarray, wsize: int) -> np.ndarray:
    """Per-band accumulator step constants (mfcc/core/filterbank.py:22-34):
    step = (1<<(2*wsize))//diff - 1 with diff = points[i+1]-points[i]-1."""
    max_acc = 1 << (2 * wsize)
    steps = []
    for i in range(len(points) - 1):
        diff = int(points[i + 1] - points[i]) - 1
        steps.append((max_acc // diff) - 1 if diff else max_acc - 1)
    return np.array(steps, dtype=object)


@functools.lru_cache(maxsize=None)
def int_filterbank_schedule(sample_rate: int = 16000, nfft: int = 512,
                            ntap: int = 32, wsize: int = 30):
    """Simulate the FilterBank input-side accumulator over one frame of
    nbins = nfft//2 samples and return the static per-sample schedule:

      weights  -- uint ``wsize``-bit ascending weight w_k = i_acc>>wsize
                  (mfcc/core/filterbank.py:113: mul.i.b = i_acc high half)
      boundary -- True where ``highest`` fires (high half == 2^wsize - 1,
                  filterbank.py:92) or the frame's last sample flushes
      band     -- filter_adr at sample k (before the post-sample increment)

    The weight sequence is data-independent, so it is a pure constant.
    """
    points = mel_filter_points(sample_rate, nfft, ntap)
    steps = mel_filter_steps(points, wsize)
    nbins = nfft // 2
    mask = (1 << wsize) - 1

    weights = np.zeros(nbins, dtype=object)
    boundary = np.zeros(nbins, dtype=bool)
    band = np.zeros(nbins, dtype=np.int64)

    i_acc = 0
    filter_adr = 0
    for k in range(nbins):
        last = (k == nbins - 1)
        w = (i_acc >> wsize) & mask
        highest = (w == mask)
        weights[k] = w
        boundary[k] = highest or last
        band[k] = filter_adr
        if highest or last:
            filter_adr = 0 if last else filter_adr + 1
            i_acc = 0
        else:
            i_acc += int(steps[filter_adr])
    return weights, boundary, band


@functools.lru_cache(maxsize=None)
def int_filterbank_matrix(sample_rate: int = 16000, nfft: int = 512,
                          ntap: int = 32, wsize: int = 30) -> np.ndarray:
    """Exact integer weight matrix W (nbins x ntap) such that the FilterBank
    output for band j is ``(sum_k d_k * W[k, j]) >> wsize`` (low 16 bits),
    replicating the o_rega/o_regb double-accumulator datapath
    (mfcc/core/filterbank.py:118-142):

      * non-boundary sample k in band b contributes ``(1<<wsize) - w_k``
        (descending complement) to the band emitted at the END of band b,
        and ``w_k`` (ascending) to the band emitted at the end of band b+1;
      * a boundary sample contributes full weight ``1<<wsize`` to the band
        emitted at the end of the NEXT band;
      * emission at the end of band b (boundary with filter_adr==b, b>=1)
        is mel filter index b-1.

    Entries are Python ints up to 2^wsize (dtype=object for exactness).
    """
    weights, boundary, band = int_filterbank_schedule(sample_rate, nfft, ntap, wsize)
    nbins = nfft // 2
    full = 1 << wsize
    W = np.zeros((nbins, ntap), dtype=object)
    for k in range(nbins):
        b = int(band[k])
        if boundary[k]:
            # regb_new = o_rega + (d << wsize): goes to emission of band b+1
            if b + 1 >= 1 and (b + 1) - 1 < ntap:
                W[k, b] += full          # emitted as mel filter (b+1)-1 = b
        else:
            w = int(weights[k])
            # descending part -> emission at end of band b = mel filter b-1
            if b >= 1 and b - 1 < ntap:
                W[k, b - 1] += full - w
            # ascending part (o_rega) -> emission at end of band b+1 = filter b
            if b < ntap:
                W[k, b] += w
    return W


def dct_fill_layout(n: int) -> np.ndarray:
    """Scatter layout of the 4N-FFT DCT trick (mfcc/core/dct_stream.py:29-34):
    returns index array ``pos`` of length n so the FFT input buffer is
    ``buf[pos[k]] = x[k]`` twice: buf[2k+1] = x[k] and buf[4n-1-2k] = x[k],
    zeros elsewhere.  Returned as (pos_a, pos_b)."""
    k = np.arange(n, dtype=np.int64)
    return 2 * k + 1, 4 * n - 1 - 2 * k
