"""Cepstral liftering (software/lift.py:12-26, notebook MFCC.ipynb cell 43).

The counterpart of ``mfcc_tpu.utils.liftering``, on tensors or numpy."""

from __future__ import annotations

import numpy as np
import torch


def lifter(cepstra, L: int = 22):
    """1 + (L/2) sin(pi*n/L) scaling of the cepstral coefficients; L<=0 is a
    no-op.  Works on numpy arrays or tensors, last axis = coefficients."""
    if L <= 0:
        return cepstra
    n = np.arange(cepstra.shape[-1])
    scale = 1 + (L / 2.0) * np.sin(np.pi * n / L)
    if isinstance(cepstra, torch.Tensor):
        dtype = (cepstra.dtype if cepstra.is_floating_point()
                 else torch.get_default_dtype())
        return cepstra * torch.as_tensor(scale, dtype=dtype,
                                         device=cepstra.device)
    return cepstra * scale
