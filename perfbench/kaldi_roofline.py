"""The least time of a batch call of Kaldi's recipe, as ``roofline.py``
gives it for the FPGA's: the larger of its bytes over the HBM rate and its
operations over the float peak.  The count is the recipe's own, the same
work whatever computes it, over the options of ``ref/kaldi_ref.py``; it is
a frozen copy of ``chip_smoke.py``'s ``kaldi_ops_per_frame``."""

from __future__ import annotations

from . import roofline
from .ref import kaldi_ref


def ops_per_frame(opts: dict) -> int:
    """Float operations of steps 2-8 a frame: over the frame's L live
    samples the sum for the mean, its subtraction, the emphasis (2) and the
    window (5 a sample) and the mean's division; the N/2-point packed
    complex FFT counted as radix-4 passes (40 a radix-4 butterfly, 4 a
    radix-2 one in a last odd pass), the real-spectrum unpack and power (19
    a bin) over the N/2 bins below Nyquist; the mel sums (2 a weight), the
    floor and the log (2 a filter); the DCT product (2 a weight), the lifter
    folded into it."""
    L, _, N = kaldi_ref.geometry(opts)
    m = N // 2
    log2m = m.bit_length() - 1
    fft = (log2m // 2) * (m // 4) * 40 + (log2m % 2) * (m // 2) * 4
    weights = int((kaldi_ref.mel_banks(opts) != 0).sum())
    nb, K = opts["num_mel_bins"], opts["num_ceps"]
    return 5 * L + 1 + fft + 19 * m + 2 * weights + 2 * nb + 2 * nb * K


def least_s(opts: dict, S: int, T: int) -> float:
    """The least time of one call on (S, T) int16 samples: the samples read
    and the float32 cepstra written once, and every frame's operations."""
    F = kaldi_ref.num_frames(T, opts)
    nbytes = S * T * 2 + S * F * opts["num_ceps"] * 4
    return roofline.least_time(nbytes, S * F * ops_per_frame(opts),
                               roofline.FLOAT_OPS_PER_S)[0]
