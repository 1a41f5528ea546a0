"""Voice-activity metric (software/cepstrum.c:161-183).

The counterpart of ``mfcc_tpu.utils.vad``, on tensors or numpy.  The
reference's host software computes sum(c0^2) over the central third of a
window of cepstral columns and compares against threshold 1e8 to decide if a
window contains voice.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_THRESHOLD = int(1e8)  # cepstrum.c:166


def voice_activity_power(cepstra):
    """sum over the central third of frames of c0^2, in int64.

    cepstra: (..., frames, ncep).  Returns (...,) power values
    (cepstrum.c:168-176 iterates x in [len/3, 2*len/3) summing col[0]^2)."""
    n = cepstra.shape[-2]
    c0 = cepstra[..., n // 3: 2 * n // 3, 0]
    if isinstance(cepstra, torch.Tensor):
        c0 = c0.to(torch.int64)
        return (c0 * c0).sum(dim=-1)
    c0 = c0.astype(np.int64)
    return np.sum(c0 * c0, axis=-1)


def has_voice(cepstra, threshold: int = DEFAULT_THRESHOLD):
    """power > threshold (cepstrum.c:178-182)."""
    return voice_activity_power(cepstra) > threshold
