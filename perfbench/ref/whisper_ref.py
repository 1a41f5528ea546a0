"""Whisper's log-mel front-end (openai/whisper ``whisper/audio.py``
``log_mel_spectrogram``) in plain float64 torch: the plain reference of the
Whisper recipe, independent of the code under test.

It imports torch and the standard library only: nothing of the program,
no kernel, no JAX.  It reads whisper's own names (``n_mels``, ``n_fft``,
``hop_length``, ``sample_rate``, ``chunk_length``), so it depends on none
of the program's field names; every option not given keeps large-v3's
value.  For each window, a row x of T samples (``pad_or_trim`` has made
T = 480,000, 30 s, where whisper runs):

1. a = x / 32768, ``load_audio``'s scale of int16;
2. reflect padding by n_fft/2: a(n) = a(-n) for n < 0 and a(2T - 2 - n)
   for n >= T (``torch.stft(center=True, pad_mode="reflect")``);
3. frame f = 0 .. T // hop - 1 is a(hop f - n_fft/2 + i), i < n_fft: the
   STFT's 1 + T // hop frames with the last dropped (``stft[..., :-1]``);
4. the periodic Hann window 0.5 - 0.5 cos(2 pi i / n_fft), the real DFT,
   P_k = |X_k|^2 for k = 0 .. n_fft/2, unscaled;
5. E = M P with M ``librosa.filters.mel(sr, n_fft, n_mels)``: the slaney
   mel scale and slaney norm over 0 .. sr/2, rounded to float32 (whisper
   reads it from ``assets/mel_filters.npz`` as float32), promoted here;
6. L = log10(max(E, 1e-10));
7. L = max(L, max(L) - 8), the max over the window's n_mels x F values;
8. (L + 4) / 4, laid out (..., n_mels, F).

Departures from whisper's float32 code, each on purpose:

* float64 throughout (whisper computes in float32): the reference is the
  equations, and a float32 computation is the program's to be held to;
* step 7 takes the max per window (a row of the batch), as Hugging Face's
  ``WhisperFeatureExtractor`` and ``whisper.transcribe`` on one file do;
  ``log_mel_spectrogram`` on a batched tensor would take it over the batch;
* P_k is re^2 + im^2 where whisper squares ``abs()``: the same in exact
  arithmetic;
* the bank is librosa's equations in float64 rounded to float32 once;
  librosa rounds the triangles to float32 before the slaney norm and then
  the product, which may differ in the last bit of some weights.
  ``mel_filters.npz`` itself is not in the repository.

``log_mel`` computes in float64 with exact products, a block of windows
at a time; its ``dtype`` and ``matmul`` (the mel product's) give the same
equations another precision.
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LOG_FLOOR = 1e-10       # torch.clamp(mel_spec, min=1e-10)
DYNAMIC_RANGE = 8.0     # torch.maximum(log_spec, log_spec.max() - 8.0)
BLOCK_WINDOWS = 8       # windows a block: 8 x 3,000 frames x 400 float64

# whisper/audio.py's constants, n_mels as openai/whisper-large-v3 sets it
DEFAULTS = {"sample_rate": 16000, "n_fft": 400, "hop_length": 160,
            "n_mels": 128, "chunk_length": 30}


def options(**given) -> dict:
    """Whisper's options with ``given`` over large-v3's; raises for an
    unknown option."""
    unknown = set(given) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"unknown Whisper options {sorted(unknown)}")
    return {**DEFAULTS, **given}


def num_frames(T: int, opts: dict) -> int:
    """Frames of a window of T samples: T // hop_length."""
    return T // opts["hop_length"]


def n_samples(opts: dict) -> int:
    """N_SAMPLES: the samples of one window, chunk_length seconds."""
    return opts["chunk_length"] * opts["sample_rate"]


def hz_to_mel(f: float) -> float:
    """librosa's slaney mel: linear below 1 kHz, logarithmic above."""
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    if f < min_log_hz:
        return f / f_sp
    return min_log_hz / f_sp + math.log(f / min_log_hz) / (math.log(6.4) / 27)


def mel_to_hz(m: torch.Tensor) -> torch.Tensor:
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27
    return torch.where(m >= min_log_mel,
                       min_log_hz * torch.exp(logstep * (m - min_log_mel)),
                       f_sp * m)


def mel_filters(opts: dict) -> torch.Tensor:
    """(n_mels, n_fft/2 + 1) float64: librosa.filters.mel (slaney scale,
    slaney norm, 0 to sr/2) rounded to float32."""
    sr, n_fft, n_mels = opts["sample_rate"], opts["n_fft"], opts["n_mels"]
    fftfreqs = torch.linspace(0, sr / 2, 1 + n_fft // 2, dtype=torch.float64)
    mel_f = mel_to_hz(torch.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2),
                                     n_mels + 2, dtype=torch.float64))
    fdiff = mel_f[1:] - mel_f[:-1]
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = torch.clamp_min(torch.minimum(lower, upper), 0.0)
    weights = weights * (2.0 / (mel_f[2:] - mel_f[:-2]))[:, None]
    return weights.to(torch.float32).to(torch.float64)


def hann(n: int) -> torch.Tensor:
    """The periodic Hann window of torch.hann_window(n)."""
    i = torch.arange(n, dtype=torch.float64)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * i / n)


def frame_index(T: int, opts: dict, device) -> torch.Tensor:
    """(F, n_fft) sample index of every frame's samples, reflected at both
    ends (steps 2-3).  Needs T > n_fft/2, as torch's reflect padding."""
    n_fft, hop = opts["n_fft"], opts["hop_length"]
    if T <= n_fft // 2:
        raise ValueError(f"{T} samples: reflect padding by {n_fft // 2} "
                         "needs more")
    n = (torch.arange(num_frames(T, opts), device=device)[:, None] * hop
         - n_fft // 2 + torch.arange(n_fft, device=device)[None, :])
    n = torch.where(n < 0, -n, n)
    return torch.where(n >= T, 2 * T - 2 - n, n)


def log_mel(x: torch.Tensor, opts: dict, dtype=torch.float64,
            matmul=None) -> torch.Tensor:
    """(B, T) samples in int16's scale -> (B, n_mels, T // hop) log-mel in
    ``dtype`` (float64: exact products), a block of BLOCK_WINDOWS windows
    at a time; ``matmul(power, bank)`` is the mel product (``@`` by
    default)."""
    matmul = matmul or (lambda a, b: a @ b)
    B, T = x.shape
    idx = frame_index(T, opts, x.device)
    win = hann(opts["n_fft"]).to(device=x.device, dtype=dtype)
    bank = mel_filters(opts).T.to(device=x.device, dtype=dtype)
    out = []
    for s in range(0, B, BLOCK_WINDOWS):
        a = x[s: s + BLOCK_WINDOWS].to(dtype) / 32768.0
        spec = torch.fft.rfft(a[:, idx] * win, dim=-1)
        power = spec.real * spec.real + spec.imag * spec.imag
        L = torch.log10(torch.clamp_min(matmul(power, bank), LOG_FLOOR))
        top = L.amax(dim=(-2, -1), keepdim=True)
        L = torch.maximum(L, top - DYNAMIC_RANGE)
        out.append(((L + 4.0) / 4.0).transpose(-1, -2))
    return torch.cat(out) if out else x.new_zeros(
        (0, opts["n_mels"], idx.shape[0]), dtype=dtype)
