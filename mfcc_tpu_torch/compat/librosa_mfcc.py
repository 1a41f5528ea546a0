"""librosa-recipe MFCC (numpy): the golden generator's algorithm.

The reference's golden tooling (software/genlibrosa.py) calls
``librosa.feature.mfcc(samples, sr=sr, hop_length=170, n_mfcc=32)`` on
float samples in [-1, 1] and writes int16 ``.spec`` files, plus
sklearn.preprocessing.scale per row as ``.sklearn``.

librosa is not available in this environment, so this module implements the
same documented default pipeline in numpy:

  stft(n_fft=2048, hop=170, hann periodic window, center=True reflect pad)
  -> |.|^2 -> slaney mel bank (n_mels=128, fmin=0, fmax=sr/2, slaney norm)
  -> power_to_db(ref=1.0, amin=1e-10, top_db=80)
  -> DCT-II ortho over the mel axis -> first n_mfcc rows.

When a real librosa is importable the test suite asserts agreement.
"""

from __future__ import annotations

import numpy as np
import scipy.fft
import scipy.signal


def hz_to_mel(freq, htk: bool = False):
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = freq >= min_log_hz
    mels = np.where(above,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz)
                    / logstep,
                    mels)
    return mels


def mel_to_hz(mels, htk: bool = False):
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = mels >= min_log_mel
    return np.where(above,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = False,
                   norm: str = "slaney") -> np.ndarray:
    """(n_mels, 1 + n_fft/2) triangular filterbank, librosa semantics."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk),
                                  n_mels + 2), htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return weights


def hann_window(n_fft: int) -> np.ndarray:
    """The periodic hann window librosa's stft uses -- the single source for
    both this numpy recipe and the JAX model (models.LibrosaMFCC)."""
    return scipy.signal.get_window("hann", n_fft, fftbins=True)


def stft_power(y: np.ndarray, n_fft: int = 2048, hop: int = 170,
               center: bool = True) -> np.ndarray:
    """|STFT|^2 with a periodic hann window, librosa framing:
    (1+n_fft/2, n_frames)."""
    y = np.asarray(y, dtype=np.float64)
    if center:
        y = np.pad(y, n_fft // 2, mode="reflect")
    win = hann_window(n_fft)
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * win
    spec = np.fft.rfft(frames, axis=-1)
    return (np.abs(spec) ** 2).T


def power_to_db(S: np.ndarray, ref: float = 1.0, amin: float = 1e-10,
                top_db: float | None = 80.0) -> np.ndarray:
    S = np.asarray(S, dtype=np.float64)
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec -= 10.0 * np.log10(np.maximum(amin, np.abs(ref)))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def melspectrogram(y: np.ndarray, sr: int = 16000, n_fft: int = 2048,
                   hop: int = 170, n_mels: int = 128) -> np.ndarray:
    S = stft_power(y, n_fft=n_fft, hop=hop)
    mel = mel_filterbank(sr, n_fft, n_mels=n_mels)
    return mel @ S


def mfcc(y: np.ndarray, sr: int = 16000, n_mfcc: int = 32, hop: int = 170,
         n_fft: int = 2048, n_mels: int = 128,
         lifter: int = 0) -> np.ndarray:
    """librosa.feature.mfcc-equivalent: (n_mfcc, n_frames).

    ``y`` may be int16 (normalized to [-1,1] like librosa.load) or float."""
    y = np.asarray(y)
    if np.issubdtype(y.dtype, np.integer):
        y = y.astype(np.float64) / 32768.0
    S_db = power_to_db(melspectrogram(y, sr, n_fft, hop, n_mels))
    M = scipy.fft.dct(S_db, axis=0, type=2, norm="ortho")[:n_mfcc]
    if lifter > 0:
        n = np.arange(n_mfcc)
        M = M * (1 + (lifter / 2.0) * np.sin(np.pi * (n[:, None] + 1)
                                             / lifter))
    return M


def sklearn_scale(x: np.ndarray, axis: int = 1) -> np.ndarray:
    """sklearn.preprocessing.scale equivalent (zero mean, unit variance,
    population std) -- the .sklearn golden (genlibrosa.py:25)."""
    x = np.asarray(x, dtype=np.float64)
    mean = x.mean(axis=axis, keepdims=True)
    std = x.std(axis=axis, keepdims=True)
    std = np.where(std == 0, 1.0, std)
    return (x - mean) / std
