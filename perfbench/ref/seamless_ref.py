"""SeamlessM4T's fbank (Hugging Face ``SeamlessM4TFeatureExtractor``, the
extractor of ``facebook/w2v-bert-2.0`` and ``facebook/seamless-m4t-v2-large``)
in plain float64 torch: the plain reference of the recipe, independent of
the code under test.

It imports torch and the standard library only: nothing of the program,
no kernel, no JAX.  It reads the extractor's own option names
(``num_mel_bins``, ``sampling_rate``, ``stride``, ``padding_value``,
``pad_to_multiple_of``), so it depends on none of the program's field
names; every option not given keeps the extractor's default.  The frame
geometry, the pre-emphasis, the floor and the bank's edges are constants of
the extractor's ``_extract_fbank_features`` and are constants here.  For
utterance s, the first n_s samples of row s, taken at their integer values
(the extractor multiplies its float input by 2^15):

1. F_s = 1 + (n_s - 400) // 160 frames of 400 samples (``center=False``);
2. the frame's mean removed (``remove_dc_offset``), then y_i = w_i - 0.97
   w_(i-1) for i >= 1 and y_0 = 0.03 w_0 (``preemphasis``);
3. the povey window (0.5 - 0.5 cos(2 pi i / 399))^0.85 (``periodic=False``),
   zero padding to 512 and the real DFT, P_k = |X_k|^2 for k < 256;
4. E = P M with M Kaldi's mel bank: triangles linear in 1127 ln(1 + f/700)
   with edges mel(20 Hz) + (b, b+1, b+2) delta, delta = (mel(8000) -
   mel(20)) / 81, weights strictly inside their edges, no norm
   (``mel_scale="kaldi"``, ``triangularize_in_mel_space``); the
   extractor's 257th row, Nyquist's, is zero and left out;
5. L = ln(max(E, 1.192092955078125e-07));
6. per mel bin, over the utterance's own F_s frames, (L - mean) /
   sqrt(var + 1e-7), var with ddof 1, both in two passes;
7. the batch padded with ``padding_value`` to F_pad, the longest F_s
   rounded up to ``pad_to_multiple_of``;
8. (B, F_pad, 80) read as (B, F_pad / stride, 80 stride), frames past
   the last multiple of stride dropped;
9. the attention mask: 1 for an utterance's own frames, padding 0, kept
   at the frames f with f mod stride = stride - 1.

Departures from the extractor, each on purpose:

* float64 throughout: the extractor frames in float64, rounds the spectrum
  to complex64, takes the log in float32 and normalises in float32; the
  reference is the equations, and a float32 computation is the program's
  to be held to;
* a row's samples past n_s are never read: the extractor is given each
  utterance unpadded, and the padding of a (B, T) batch is the caller's;
* an utterance under 560 samples (F_s < 2) raises, where the extractor
  divides by zero in its variance and returns NaN;
* the DFT is a product with cos and sin tables over the frame's 400
  samples, which is the zero-padded 512-point DFT.

``features`` computes in float64 with exact products, an utterance at a
time; its ``dtype`` and ``matmul`` (every product's) give the same
equations another precision, and ``fft`` takes the spectrum by
``torch.fft.rfft`` of the frame zero-padded to 512 in place of the
tables' product: the program's algorithm, for a reading one precision
down.
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# _extract_fbank_features' constants
FRAME_LENGTH = 400
HOP_LENGTH = 160
FFT_LENGTH = 512
PREEMPHASIS = 0.97
MEL_FLOOR = 1.192092955078125e-07
MIN_FREQUENCY = 20.0
VARIANCE_FLOOR = 1e-7

# SeamlessM4TFeatureExtractor's defaults, spelled as it spells them
DEFAULTS = {"feature_size": 80, "sampling_rate": 16000, "num_mel_bins": 80,
            "padding_value": 0.0, "stride": 2, "pad_to_multiple_of": 2,
            "do_normalize_per_mel_bins": True}


def options(**given) -> dict:
    """The extractor's options with ``given`` over its defaults; raises for
    an unknown option or one this file does not compute."""
    unknown = set(given) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"unknown extractor options {sorted(unknown)}")
    opts = {**DEFAULTS, **given}
    if not opts["do_normalize_per_mel_bins"]:
        raise ValueError("this reference computes "
                         "do_normalize_per_mel_bins=True only")
    return opts


def num_frames(n: int, opts: dict) -> int:
    """Frames of an utterance of n samples (snip-edges): 0 below one."""
    return 0 if n < FRAME_LENGTH else 1 + (n - FRAME_LENGTH) // HOP_LENGTH


def padded_frames(counts, opts: dict) -> int:
    """F_pad: the largest frame count rounded up to pad_to_multiple_of."""
    m = opts["pad_to_multiple_of"]
    return -(-max(counts) // m) * m


def povey_window() -> torch.Tensor:
    a = 2.0 * math.pi / (FRAME_LENGTH - 1)
    return torch.tensor([(0.5 - 0.5 * math.cos(a * i)) ** 0.85
                         for i in range(FRAME_LENGTH)], dtype=torch.float64)


def mel_scale(f: float) -> float:
    return 1127.0 * math.log(1.0 + f / 700.0)


def mel_banks(opts: dict) -> torch.Tensor:
    """(FFT_LENGTH/2, num_mel_bins) float64: the triangles over the bins
    below Nyquist, bin i at frequency i * sampling_rate / FFT_LENGTH."""
    sr, nb = opts["sampling_rate"], opts["num_mel_bins"]
    lo_mel, hi_mel = mel_scale(MIN_FREQUENCY), mel_scale(sr // 2)
    delta = (hi_mel - lo_mel) / (nb + 1)
    W = torch.zeros((FFT_LENGTH // 2, nb), dtype=torch.float64)
    for b in range(nb):
        left = lo_mel + b * delta
        center = lo_mel + (b + 1) * delta
        right = lo_mel + (b + 2) * delta
        for i in range(FFT_LENGTH // 2):
            mel = mel_scale(sr / FFT_LENGTH * i)
            if left < mel < right:
                W[i, b] = ((mel - left) / (center - left) if mel <= center
                           else (right - mel) / (right - center))
    return W


def _tables(opts: dict, dtype, device) -> dict:
    n = torch.arange(FRAME_LENGTH, dtype=torch.float64)[:, None]
    k = torch.arange(FFT_LENGTH // 2, dtype=torch.float64)[None, :]
    ang = 2.0 * math.pi * n * k / FFT_LENGTH
    t = {"window": povey_window(), "cos": torch.cos(ang),
         "sin": -torch.sin(ang), "mel": mel_banks(opts)}
    return {name: a.to(dtype=dtype, device=device) for name, a in t.items()}


def log_mel(x: torch.Tensor, t: dict, mm, fft: bool = False
            ) -> torch.Tensor:
    """(F, 400) frames of samples -> (F, num_mel_bins), steps 2-5."""
    w = x - x.mean(dim=1, keepdim=True)                         # 2
    y = torch.empty_like(w)
    y[:, 1:] = w[:, 1:] - PREEMPHASIS * w[:, :-1]
    y[:, 0] = w[:, 0] - PREEMPHASIS * w[:, 0]
    y = y * t["window"]                                          # 3
    if fft:
        spec = torch.fft.rfft(y, n=FFT_LENGTH, dim=1)[:, : FFT_LENGTH // 2]
        re, im = spec.real, spec.imag
    else:
        re, im = mm(y, t["cos"]), mm(y, t["sin"])
    energy = mm(re * re + im * im, t["mel"])                     # 4
    return torch.log(torch.clamp_min(energy, MEL_FLOOR))        # 5


def normalize(L: torch.Tensor) -> torch.Tensor:
    """Step 6 on one utterance's (F, bins) log-mel, F >= 2."""
    mean = L.mean(dim=0, keepdim=True)
    d = L - mean
    var = (d * d).sum(dim=0, keepdim=True) / (L.shape[0] - 1)
    return d / torch.sqrt(var + VARIANCE_FLOOR)


def features(audio: torch.Tensor, lengths, opts: dict, *,
             dtype=torch.float64, matmul=torch.matmul, fft=False):
    """(B, T) samples and (B,) lengths (None: every row whole) ->
    (input_features (B, F_pad / stride, num_mel_bins * stride) in
    ``dtype``, attention_mask (B, F_pad / stride) int32), on ``audio``'s
    device."""
    B, T = audio.shape
    n = ([T] * B if lengths is None
         else [int(v) for v in torch.as_tensor(lengths).tolist()])
    counts = [num_frames(v, opts) for v in n]
    for v, F in zip(n, counts):
        if not 0 <= v <= T or F < 2:
            raise ValueError(f"an utterance of {v} samples in a row of {T}: "
                             "the unbiased variance needs two frames, "
                             f"{FRAME_LENGTH + HOP_LENGTH} samples")
    nb, stride = opts["num_mel_bins"], opts["stride"]
    Fp = padded_frames(counts, opts)
    out = torch.full((B, Fp, nb), float(opts["padding_value"]), dtype=dtype,
                     device=audio.device)
    mask = torch.zeros((B, Fp), dtype=torch.int32, device=audio.device)
    t = _tables(opts, dtype, audio.device)
    for s, (v, F) in enumerate(zip(n, counts)):
        frames = audio[s, :v].to(dtype).unfold(0, FRAME_LENGTH, HOP_LENGTH)
        out[s, :F] = normalize(log_mel(frames, t, matmul, fft))  # 1-6
        mask[s, :F] = 1                                         # 7
    Fr = Fp - Fp % stride                       # the extractor's remainder
    return (out[:, :Fr].reshape(B, Fr // stride, nb * stride),  # 8
            mask[:, stride - 1: Fr: stride].contiguous())       # 9
