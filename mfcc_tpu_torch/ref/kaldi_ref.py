"""Kaldi's MFCC (``compute-mfcc-feats``) in plain float64 torch: the plain
reference of the Kaldi recipe, independent of the code under test.

It imports torch and the standard library only: nothing of the program,
no kernel, no JAX.  It reads Kaldi's option names and values as Kaldi
spells them (``--num-mel-bins`` is ``num_mel_bins``), so it depends on
none of the program's field names; every option not given keeps Kaldi's
default.  For frame f of a row x of samples, taken at their integer values
(src/feat: feature-window.cc, feature-mfcc.cc, mel-computations.cc,
matrix/matrix-functions.cc):

1. framing (snip-edges): F = (T - L) // shift + 1 frames of L samples,
   frame f = x[shift f : shift f + L];
2. the frame's DC offset removed: w = x - mean(x);
3. pre-emphasis inside the frame (Preemphasize): y_i = w_i - c w_(i-1) for
   i >= 1, y_0 = w_0 - c w_0;
4. the povey window, (0.5 - 0.5 cos(2 pi i / (L - 1)))^0.85, then zero
   padding to N, the next power of two, and the real DFT;
5. power |X_k|^2, no 1/N, and Kaldi's mel banks over bins [0, N/2);
6. ln(max(E_b, FLT_EPSILON));
7. the first num_ceps rows of ComputeDctMatrix (orthonormal DCT-II);
8. the lifter 1 + Q/2 sin(pi k / Q).

The DFT is a product with cos and sin tables over the frame's L samples,
which is the zero-padded N-point DFT (the padding adds zero terms); each
stage is the equation above on a block of frames.

Departure from Kaldi: ``dither`` must be 0.  Kaldi's default of 1.0 adds
Gaussian noise from Kaldi's own generator to every sample, so a dithered
output cannot be compared element by element; deterministic extraction
sets ``--dither=0``.  Options this file does not compute (``use_energy``,
another window, no DC removal, no snip-edges, VTLN, HTK mode) raise.

``mfcc`` computes in float64 with exact products; its ``dtype`` and
``matmul`` give the same equations another precision.
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FLT_EPSILON = 1.1920928955078125e-07   # std::numeric_limits<float>::epsilon()
BLOCK_FRAMES = 1 << 15                 # frames a block

# compute-mfcc-feats' defaults (MfccOptions, FrameExtractionOptions,
# MelBanksOptions), spelled as Kaldi spells them
DEFAULTS = {"sample_frequency": 16000.0, "frame_length_ms": 25.0,
            "frame_shift_ms": 10.0, "dither": 1.0,
            "preemphasis_coefficient": 0.97, "remove_dc_offset": True,
            "window_type": "povey", "round_to_power_of_two": True,
            "snip_edges": True, "num_mel_bins": 23, "low_freq": 20.0,
            "high_freq": 0.0, "num_ceps": 13, "use_energy": True,
            "cepstral_lifter": 22.0, "htk_compat": False}
# the values this file computes, where Kaldi allows others
REQUIRED = {"dither": 0.0, "remove_dc_offset": True, "window_type": "povey",
            "round_to_power_of_two": True, "snip_edges": True,
            "use_energy": False, "htk_compat": False}


def options(**given) -> dict:
    """Kaldi's options with ``given`` over the defaults; raises for an
    unknown option or a value this file does not compute."""
    unknown = set(given) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"unknown Kaldi options {sorted(unknown)}")
    opts = {**DEFAULTS, **given}
    for name, value in REQUIRED.items():
        if opts[name] != value:
            raise ValueError(f"{name}={opts[name]!r}: this reference "
                             f"computes {name}={value!r} only")
    return opts


def geometry(opts: dict) -> tuple[int, int, int]:
    """(L, shift, N): FrameExtractionOptions' WindowSize, WindowShift and
    PaddedWindowSize."""
    sr = opts["sample_frequency"]
    L = int(sr * 0.001 * opts["frame_length_ms"])
    shift = int(sr * 0.001 * opts["frame_shift_ms"])
    return L, shift, 1 << (L - 1).bit_length()


def num_frames(T: int, opts: dict) -> int:
    """NumFrames with snip-edges: 0 below one frame."""
    L, shift, _ = geometry(opts)
    return 0 if T < L else (T - L) // shift + 1


def povey_window(L: int) -> torch.Tensor:
    a = 2.0 * math.pi / (L - 1)
    return torch.tensor([(0.5 - 0.5 * math.cos(a * i)) ** 0.85
                         for i in range(L)], dtype=torch.float64)


def mel_scale(f: float) -> float:
    return 1127.0 * math.log(1.0 + f / 700.0)


def mel_banks(opts: dict) -> torch.Tensor:
    """(N/2, num_mel_bins) float64: MelBanks' weights over the FFT bins
    below Nyquist, bin i at frequency i * sample_frequency / N."""
    sr, nb = opts["sample_frequency"], opts["num_mel_bins"]
    _, _, N = geometry(opts)
    nyquist = 0.5 * sr
    high = (opts["high_freq"] if opts["high_freq"] > 0
            else nyquist + opts["high_freq"])
    lo_mel, hi_mel = mel_scale(opts["low_freq"]), mel_scale(high)
    delta = (hi_mel - lo_mel) / (nb + 1)
    W = torch.zeros((N // 2, nb), dtype=torch.float64)
    for b in range(nb):
        left = lo_mel + b * delta
        center = lo_mel + (b + 1) * delta
        right = lo_mel + (b + 2) * delta
        for i in range(N // 2):
            mel = mel_scale(sr / N * i)
            if left < mel < right:
                W[i, b] = ((mel - left) / (center - left) if mel <= center
                           else (right - mel) / (right - center))
    return W


def dct_matrix(opts: dict) -> torch.Tensor:
    """(num_ceps, num_mel_bins): rows k of ComputeDctMatrix,
    sqrt(1/n) at k = 0 and sqrt(2/n) cos(pi k (b + 0.5) / n) after."""
    n, K = opts["num_mel_bins"], opts["num_ceps"]
    M = torch.empty((K, n), dtype=torch.float64)
    for k in range(K):
        for b in range(n):
            M[k, b] = (math.sqrt(1.0 / n) if k == 0 else
                       math.sqrt(2.0 / n) * math.cos(math.pi / n * (b + 0.5)
                                                     * k))
    return M


def lifter(opts: dict) -> torch.Tensor:
    """(num_ceps,) ComputeLifterCoeffs: 1 + Q/2 sin(pi k / Q); ones for
    Q = 0."""
    Q, K = opts["cepstral_lifter"], opts["num_ceps"]
    if not Q:
        return torch.ones(K, dtype=torch.float64)
    return torch.tensor([1.0 + 0.5 * Q * math.sin(math.pi * k / Q)
                         for k in range(K)], dtype=torch.float64)


def _tables(opts: dict, dtype, device) -> dict:
    L, _, N = geometry(opts)
    n = torch.arange(L, dtype=torch.float64)[:, None]
    k = torch.arange(N // 2 + 1, dtype=torch.float64)[None, :]
    ang = 2.0 * math.pi * n * k / N
    t = {"window": povey_window(L), "cos": torch.cos(ang),
         "sin": -torch.sin(ang), "mel": mel_banks(opts),
         "dct": dct_matrix(opts).T, "lifter": lifter(opts)}
    return {name: a.to(dtype=dtype, device=device) for name, a in t.items()}


def _frames(x: torch.Tensor, t: dict, opts: dict, mm) -> torch.Tensor:
    """(M, L) frames of samples -> (M, num_ceps), steps 2-8."""
    c = opts["preemphasis_coefficient"]
    w = x - x.mean(dim=1, keepdim=True)                        # 2
    y = torch.empty_like(w)                                     # 3
    y[:, 1:] = w[:, 1:] - c * w[:, :-1]
    y[:, 0] = w[:, 0] - c * w[:, 0]
    y = y * t["window"]                                         # 4
    re, im = mm(y, t["cos"]), mm(y, t["sin"])
    power = re * re + im * im                                   # 5
    energy = mm(power[:, : t["mel"].shape[0]], t["mel"])
    logmel = torch.log(torch.clamp_min(energy, FLT_EPSILON))    # 6
    return mm(logmel, t["dct"]) * t["lifter"]                   # 7, 8


def mfcc(audio: torch.Tensor, opts: dict, *, dtype=torch.float64,
         matmul=torch.matmul) -> torch.Tensor:
    """(S, T) samples -> (S, F, num_ceps) cepstra on ``audio``'s device,
    computed in ``dtype`` with ``matmul`` for every product."""
    L, shift, _ = geometry(opts)
    x = audio.to(dtype)
    S, T = x.shape
    F = num_frames(T, opts)
    out = torch.empty((S, F, opts["num_ceps"]), dtype=dtype,
                      device=x.device)
    if F == 0:
        return out
    t = _tables(opts, dtype, x.device)
    frames = x.unfold(1, L, shift)                              # 1
    rows = max(1, BLOCK_FRAMES // F)
    for s in range(0, S, rows):
        blk = frames[s: s + rows].reshape(-1, L)
        out[s: s + rows] = _frames(blk, t, opts, matmul).reshape(
            -1, F, opts["num_ceps"])
    return out

