"""The least time of a batch call of SeamlessM4T's fbank on a ragged batch,
and of its normalisation alone, as ``roofline.py`` gives it for the FPGA's:
the larger of the bytes over the HBM rate and the operations over the float
peak.  The count is the recipe's own, the same work whatever computes it,
over the options of ``ref/seamless_ref.py``: the utterances' own frames,
never the padding."""

from __future__ import annotations

from . import roofline
from .ref import seamless_ref


def ops_per_frame(opts: dict) -> int:
    """Float operations of steps 2-6 a frame: over the frame's L samples
    the sum for the mean, its subtraction, the emphasis (2) and the window
    (5 a sample) and the mean's division; the N/2-point packed complex FFT
    counted as radix-4 passes (40 a radix-4 butterfly, 4 a radix-2 one in
    a last odd pass), the real-spectrum unpack and power (19 a bin) over
    the N/2 bins below Nyquist; the mel sums (2 a weight), the floor and
    the log (2 a bin); and a bin's statistics (its sum, a difference, a
    square and a sum: 4) and normalisation (a difference and a quotient:
    2)."""
    L, N = seamless_ref.FRAME_LENGTH, seamless_ref.FFT_LENGTH
    m = N // 2
    log2m = m.bit_length() - 1
    fft = (log2m // 2) * (m // 4) * 40 + (log2m % 2) * (m // 2) * 4
    weights = int((seamless_ref.mel_banks(opts) != 0).sum())
    nb = opts["num_mel_bins"]
    return 5 * L + 1 + fft + 19 * m + 2 * weights + 2 * nb + 6 * nb


def _geometry(opts: dict, lengths) -> tuple[int, int, int]:
    """(utterances, own frames, F_pad) of a call on these lengths."""
    counts = [seamless_ref.num_frames(int(n), opts) for n in lengths]
    return len(counts), sum(counts), seamless_ref.padded_frames(counts, opts)


def output_bytes(opts: dict, lengths) -> int:
    """The stacked f32 features and the int32 mask, padding included."""
    B, _, Fp = _geometry(opts, lengths)
    return B * Fp * opts["num_mel_bins"] * 4 + B * (Fp // opts["stride"]) * 4


def least_s(opts: dict, lengths) -> float:
    """The least time of one call on utterances of these lengths (int16):
    their own samples read and the whole output written once, and every
    own frame's operations."""
    _, own, _ = _geometry(opts, lengths)
    nbytes = 2 * sum(int(n) for n in lengths) + output_bytes(opts, lengths)
    return roofline.least_time(nbytes, own * ops_per_frame(opts),
                               roofline.FLOAT_OPS_PER_S)[0]


def cmvn_least_s(opts: dict, lengths) -> float:
    """The normalisation's least time, by bytes: the own frames' log-mel
    read once in float64, the precision the recipe keeps until the
    normalised value, and the whole output written once."""
    _, own, _ = _geometry(opts, lengths)
    nbytes = own * opts["num_mel_bins"] * 8 + output_bytes(opts, lengths)
    return nbytes / roofline.HBM_BYTES_PER_S
