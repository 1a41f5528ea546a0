"""The least time of a batch call of Whisper's log-mel recipe, as
``roofline.py`` gives it for the FPGA's: the larger of its bytes over the
HBM rate and its operations over the float peak.  The count is the
recipe's own, the same work whatever computes it, over the options of
``ref/whisper_ref.py``; it is a frozen copy of ``chip_smoke.py``'s
``whisper_ops_per_frame``."""

from __future__ import annotations

from . import roofline
from .ref import whisper_ref

# real operations of a radix-8 butterfly without twiddles (two 4-point
# DFTs after a radix-2 split and its three nontrivial rotations) and of a
# radix-5 one with its four complex twiddle products
RADIX8_OPS = 56
RADIX5_OPS = 72


def ops_per_frame(opts: dict) -> int:
    """Float operations of steps 1-8 a frame: the window over the frame's
    n_fft samples (1 a sample, the 1/32768 folded into it); the n_fft/2 =
    200-point packed complex FFT as 8 x 5 x 5 (25 radix-8 and 2 x 40
    radix-5 butterflies); the real-spectrum unpack and power (19 a bin)
    over the 200 bins below Nyquist; the mel sums (2 a nonzero weight);
    and a filter's floor, log, share of the window's max, clamp and affine
    (6 a filter)."""
    n = opts["n_fft"] // 2
    if n != 200:
        raise ValueError("the count is the 8 x 5 x 5 FFT of n_fft 400")
    fft = 25 * RADIX8_OPS + 2 * 40 * RADIX5_OPS
    weights = int((whisper_ref.mel_filters(opts) != 0).sum())
    return opts["n_fft"] + fft + 19 * n + 2 * weights + 6 * opts["n_mels"]


def least_s(opts: dict, B: int, T: int) -> float:
    """The least time of one call on (B, T) int16 samples: the samples read
    and the float32 log-mel written once, and every frame's operations."""
    F = whisper_ref.num_frames(T, opts)
    nbytes = B * T * 2 + B * F * opts["n_mels"] * 4
    return roofline.least_time(nbytes, B * F * ops_per_frame(opts),
                               roofline.FLOAT_OPS_PER_S)[0]
