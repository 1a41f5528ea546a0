"""The least time the card could take for a call or a step: the larger of
its bytes over the HBM rate and its operations over the peak rate of their
type.  The operation counts are frozen copies of ``chip_smoke.py``'s
(``k1_flops_per_frame``, ``ladder_ops``, ``int_ops_per_frame``); the bands
they count are worked out again from the configuration with ``ref.tables``.

Peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).  The float
function is held to 67 TFLOP/s, the FP32 rate and the FP64 tensor-core
rate alike, so a kernel that changes its unit (FP64 outside the tensor
cores, FP64 on them, FP32) cannot read above 100% by that change alone.
The INT function is held to the int32 issue limit of 4 schedulers x 32
lanes a clock an SM, 132 SMs at 1.98 GHz.
"""

from __future__ import annotations

import numpy as np

from .ref import tables
from .ref.config import MFCCConfig

HBM_BYTES_PER_S = 3.35e12
FLOAT_OPS_PER_S = 67e12
INT32_OPS_PER_S = 128 * 132 * 1.98e9


def _bands(matrix: np.ndarray) -> list:
    """[lo, hi) of the nonzero rows of each column."""
    nz = np.asarray(matrix != 0)
    return [(int(np.argmax(nz[:, j])), len(nz) - int(np.argmax(nz[::-1, j])))
            for j in range(nz.shape[1])]


def float_bands(cfg: MFCCConfig) -> list:
    """The float mel filters' bands over the first nfft/2 bins (K1's)."""
    mel = tables.float_mel_matrix(cfg.samplerate, cfg.nfft, cfg.nfilters)
    return _bands(mel[: cfg.nfft // 2])


def int_bands(cfg: MFCCConfig) -> list:
    """The INT filterbank's bands (the nonzero rows of its exact matrix)."""
    W = tables.int_filterbank_matrix(cfg.samplerate, cfg.nfft, cfg.nfilters,
                                     cfg.filter_wsize)
    return _bands(W.astype(np.int64))


def k1_flops_per_frame(cfg: MFCCConfig, band: list) -> int:
    """Float operations of the float MFCC function per frame: ingest
    (emphasis and window on sample pairs, 6 per packed point), the packed
    nfft/2-point complex FFT counted as radix-4 passes (40 per radix-4
    butterfly) and a radix-2 pass when the stage count is odd, the
    real-spectrum unpack and power (19 per bin), the banded mel sums (2 per
    weight), a log2 per filter and the DCT product (2 per weight)."""
    m = cfg.nfft // 2
    log2m = m.bit_length() - 1
    fft = (log2m // 2) * (m // 4) * 40 + (log2m % 2) * (m // 2) * 4
    mel = 2 * sum(hi - lo for lo, hi in band)
    return (6 * m + fft + 19 * m + mel + cfg.nfilters
            + 2 * cfg.nfilters * cfg.nceptrums)


def ladder_ops(log2n: int, nz_re, nz_im, live_re, live_im) -> int:
    """int32 operations that the RTL's radix-2 DIT ladder on 2^log2n points
    needs.  ``nz_*`` say which inputs, in bit-reversed order, can be
    nonzero; ``live_*`` which outputs (natural order) are used.  A
    butterfly costs what its nonzero inputs and live outputs need, at most
    21."""
    n = 1 << log2n
    nzr, nzi = list(nz_re), list(nz_im)

    def pairs(s):
        span = 1 << s
        return [(((t >> s) << (s + 1)) + (t & (span - 1)),
                 ((t >> s) << (s + 1)) + (t & (span - 1)) + span)
                for t in range(n // 2)]

    seen = []
    for s in range(log2n):        # forward: which values can be nonzero
        seen.append((nzr[:], nzi[:]))
        for i0, i1 in pairs(s):
            x1 = nzr[i1] or nzi[i1]
            nzr[i0] = nzr[i1] = nzr[i0] or x1
            nzi[i0] = nzi[i1] = nzi[i0] or x1
    ops = 0
    lr, li = list(live_re), list(live_im)
    for s in reversed(range(log2n)):   # backward: what each stage must do
        nzr, nzi = seen[s]
        for i0, i1 in pairs(s):
            need1, need2 = lr[i0] or lr[i1], li[i0] or li[i1]
            x1 = nzr[i1] or nzi[i1]
            if x1 and (need1 or need2):
                ops += 2 + (nzr[i1] and nzi[i1])
                ops += need1 * (1 + 2 * nzi[i1]) + need2 * (1 + 2 * nzr[i1])
            for live, a, neg in ((lr[i0], nzr[i0], False),
                                 (lr[i1], nzr[i0], True),
                                 (li[i0], nzi[i0], False),
                                 (li[i1], nzi[i0], True)):
                if live and (a or x1):
                    ops += 2 + (a and x1) + (neg and not a)
            lr[i0], li[i0] = need1, need2
            lr[i1] = li[i1] = need1 or need2
    return ops


def int_ops_per_frame(cfg: MFCCConfig, band: list) -> int:
    """int32 operations of the INT MFCC function per frame, after
    pre-emphasis: the window (3 per point), the nfft-point ladder on a real
    input whose bins outside every band are unused, power (4 per used bin),
    the banded filterbank (2 per weight, 2 per filter), log2 (7, and 5 per
    square-and-compare round) and the 4*nfilters-point DCT ladder on the
    scattered log-mel row of which bins [0, ncep) are used."""
    nfft, nf = cfg.nfft, cfg.nfilters
    lg = nfft.bit_length() - 1
    used = [False] * nfft
    for lo, hi in band:
        used[lo:hi] = [True] * (hi - lo)
    fft = ladder_ops(lg, [True] * nfft, [False] * nfft, used, used)
    n4 = 4 * nf
    lg4 = n4.bit_length() - 1
    odd = [bool(int(f"{i:0{lg4}b}"[::-1], 2) & 1) for i in range(n4)]
    ncep = min(cfg.nceptrums, nf)
    dct = ladder_ops(lg4, odd, [False] * n4,
                     [i < ncep for i in range(n4)], [False] * n4)
    fb = 2 * sum(hi - lo for lo, hi in band) + 2 * nf
    log2 = nf * (7 + 5 * (cfg.log_precision - 1))
    return 3 * nfft + fft + 4 * sum(used) + fb + log2 + dct


def least_time(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the two bounds."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def batch_call(cfg: MFCCConfig, path: str, S: int, T: int
               ) -> tuple[float, str]:
    """One batch call on (S, T) int16: the samples read once, the float32 or
    int32 cepstra written once."""
    frames = S * cfg.n_frames(T)
    nbytes = S * T * 2 + frames * cfg.nceptrums * 4
    if path == "int":
        ops = 4 * S * T + frames * int_ops_per_frame(cfg, int_bands(cfg))
        return least_time(nbytes, ops, INT32_OPS_PER_S)
    ops = frames * k1_flops_per_frame(cfg, float_bands(cfg))
    return least_time(nbytes, ops, FLOAT_OPS_PER_S)


def stream_step(cfg: MFCCConfig, path: str, S: int, C: int, valid: int,
                slots: int) -> tuple[float, str]:
    """One streaming step of S int16 chunks of C samples with ``valid``
    frames among S x ``slots`` slots: the chunk, the carry in and out, the
    count and prev in and out, the mask and the features."""
    P = cfg.windowlen - 1
    nbytes = (S * C * 2 + 2 * S * P * 4 + 4 * S * 4 + S * slots
              + S * slots * cfg.nceptrums * 4)
    if path == "int":
        ops = 4 * S * C + valid * int_ops_per_frame(cfg, int_bands(cfg))
        return least_time(nbytes, ops, INT32_OPS_PER_S)
    ops = 2 * S * C + valid * k1_flops_per_frame(cfg, float_bands(cfg))
    return least_time(nbytes, ops, FLOAT_OPS_PER_S)
