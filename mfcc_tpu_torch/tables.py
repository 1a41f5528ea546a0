"""Constant tables of the float path (numpy/scipy, float64).

The float part of ``mfcc_tpu.tables``, copied function for function so that
the outputs are bit-identical: the periodic Hamming window, the triangular
mel filterbank, the orthonormal DCT-II basis and the windowed real-DFT
operator.  Callers cast to their working dtype; the tables stay float64.
The fixed-point (INT path) tables are not here yet.
"""

from __future__ import annotations

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
