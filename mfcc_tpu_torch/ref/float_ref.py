"""Float reference pipeline (numpy, float64).

A line-by-line port of the executable algorithm spec in
reference notebook/MFCC-INT.ipynb (cells 2-10), which is itself the float
model the RTL quantizes.  This is the oracle the float paths are tested
against: a copy of ``mfcc_tpu.ref.float_ref`` (numpy and scipy only, same
results bit for bit), so that a host without JAX can gate against it.
"""

from __future__ import annotations

import numpy as np
import scipy.fft

from ..config import MFCCConfig
from .. import tables

EMPHASIS_COEFF = 0.96875  # 1 - 1/32 (MFCC-INT.ipynb cell 2, preemph.py:6)


def preemphasis(audio: np.ndarray) -> np.ndarray:
    """y[0] = x[0]; y[t] = x[t] - 0.96875*x[t-1] (MFCC-INT.ipynb cell 2)."""
    audio = np.asarray(audio, dtype=np.float64)
    return np.append(audio[0], audio[1:] - EMPHASIS_COEFF * audio[:-1])


def frame_audio(audio: np.ndarray, nfft: int = 512, hop: int = 170) -> np.ndarray:
    """Overlapped framing (MFCC-INT.ipynb cell 3)."""
    audio = np.asarray(audio, dtype=np.float64)
    n = int((len(audio) - nfft) / hop) + 1
    frames = np.zeros((n, nfft))
    for i in range(n):
        frames[i] = audio[i * hop: i * hop + nfft]
    return frames


def mfcc_float(audio: np.ndarray, cfg: MFCCConfig = MFCCConfig(),
               return_intermediates: bool = False):
    """Full float pipeline on a 1-D int16/float signal -> (nframes, nceptrums).

    Stages and constants mirror MFCC-INT.ipynb cells 2-10:
    preemph -> frame(512/170) -> periodic hamming -> fft/512 [0:257]
    -> |.|^2 -> triangular mel (no enorm) -> log2 -> DCT-II ortho
    -> keep first nceptrums.
    """
    emph = preemphasis(audio)
    frames = frame_audio(emph, cfg.nfft, cfg.hop)
    win = frames * tables.float_window(cfg.nfft)
    spec = np.fft.rfft(win, axis=-1) / cfg.nfft
    power = np.abs(spec) ** 2
    mel = power @ tables.float_mel_matrix(cfg.samplerate, cfg.nfft, cfg.nfilters)
    logmel = np.log2(mel)
    cep = scipy.fft.dct(logmel, type=2, norm="ortho", axis=-1)
    out = cep[:, : cfg.nceptrums]
    if return_intermediates:
        return out, dict(emph=emph, frames=frames, win=win, spec=spec,
                         power=power, mel=mel, logmel=logmel, cep=cep)
    return out


def lifter(cepstra: np.ndarray, L: int = 22) -> np.ndarray:
    """Cepstral liftering 1+(L/2)sin(pi*n/L) (software/lift.py:12-26)."""
    if L <= 0:
        return cepstra
    n = np.arange(cepstra.shape[-1])
    return cepstra * (1 + (L / 2.0) * np.sin(np.pi * n / L))
