"""Pre-emphasis and overlapped framing on torch tensors.

The counterpart of ``mfcc_tpu.ops.framing``: pre-emphasis (float, and the
INT path's fixed-point form with its 16-bit wrap) is a shifted subtract
over the last axis and framing is a strided view (``Tensor.unfold``), so no
gather index is materialized.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EMPHASIS_COEFF = 0.96875  # 1 - 1/32


def preemphasis(x: torch.Tensor, carry: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Float pre-emphasis y[t] = x[t] - 0.96875*x[t-1] over the last axis.

    ``carry`` is the previous sample from an earlier chunk (streaming); with
    carry=None the first output equals x[0] (the RTL's previous-sample
    register resets to 0: y[0] = x[0] + 0 - 0)."""
    if carry is None:
        first = x.new_zeros(x.shape[:-1] + (1,))
    else:
        first = carry.to(x.dtype)[..., None]
    prev = torch.cat([first, x[..., :-1]], dim=-1)
    return x - EMPHASIS_COEFF * prev


def kaldi_preemphasis(frames: torch.Tensor, coeff: float) -> torch.Tensor:
    """Kaldi's DC removal and pre-emphasis inside each frame, on (..., L)
    frames of raw samples (feature-window.cc ProcessWindow, Preemphasize):
    with mu the frame's mean, y_i = (x_i - mu) - c (x_(i-1) - mu) for i >= 1
    and y_0 = (x_0 - mu) - c (x_0 - mu).  Computed as the kernel computes
    it: y_i = x_i - c x_(i-1) - (1 - c) mu, with x_(-1) taken as x_0 (the
    algebra is in ``csrc/fladder_stages.cuh``, ``kaldi_ingest``).  Nothing
    carries from one frame to the next."""
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    mu = frames.mean(dim=-1, keepdim=True)
    return (frames - coeff * prev) - (1.0 - coeff) * mu


def preemphasis_int(x: torch.Tensor, carry: torch.Tensor | None = None,
                    width: int = 16) -> torch.Tensor:
    """Fixed-point pre-emphasis: y = wrap_w(x + (prev >> 5) - prev)
    (mfcc/core/preemph.py:23).  x int32 holding width-bit-range samples;
    the sum wraps mod 2^32 as in the JAX package, and only its low
    ``width`` bits are kept."""
    if carry is None:
        first = x.new_zeros(x.shape[:-1] + (1,))
    else:
        first = carry.to(x.dtype)[..., None]
    prev = torch.cat([first, x[..., :-1]], dim=-1)
    return wrap_signed(x + (prev >> 5) - prev, width)


def wrap_signed(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Truncate to ``bits`` bits and sign-extend (nMigen signed assignment)."""
    mask = (1 << bits) - 1
    sign = 1 << (bits - 1)
    return ((v & mask) ^ sign) - sign


def align_rows(x: torch.Tensor, start: torch.Tensor, out_len: int
               ) -> torch.Tensor:
    """Per-row dynamic alignment, ``out[s, j] = x[s, start[s] + j]``, as
    one indexed read (``torch.gather``).  The streaming step's contract is
    ``start[s] + out_len <= x.shape[1]``; indices outside the row are
    clamped to its ends, so a corrupt offset never faults the device.
    (The JAX package builds this as a barrel shifter of rolls and selects,
    because row-varying gathers are slow on a TPU; on a GPU it is one
    load per element.)"""
    idx = (start.to(torch.int64)[:, None]
           + torch.arange(out_len, device=x.device)[None, :])
    return torch.gather(x, 1, idx.clamp_(0, x.shape[1] - 1))


def num_frames(n_samples: int, hop: int, windowlen: int) -> int:
    """Frames in a signal of ``n_samples``; raises for a signal shorter than
    one frame (the same message as the JAX package)."""
    n = (n_samples - windowlen) // hop + 1
    if n <= 0:
        raise ValueError(
            f"signal of {n_samples} samples is shorter than one frame "
            f"({windowlen})")
    return n


def frame_indices(n_samples: int, nfft: int, hop: int,
                  windowlen: int | None = None) -> torch.Tensor:
    """(nframes, windowlen) int64 index matrix of the overlapped frames.
    ``windowlen`` is the number of REAL samples per frame (a frame completes
    after windowlen samples, mfcc/core/frame.py:86-91); defaults to nfft."""
    wl = windowlen or nfft
    n = num_frames(n_samples, hop, wl)
    starts = torch.arange(n, dtype=torch.int64) * hop
    return starts[:, None] + torch.arange(wl, dtype=torch.int64)[None, :]


def extract_frames(x: torch.Tensor, nfft: int, hop: int,
                   windowlen: int | None = None) -> torch.Tensor:
    """Overlapped frames: (..., T) -> (..., F, nfft).

    A strided view of ``x`` when windowlen == nfft; with windowlen < nfft,
    positions >= windowlen are zero-padded (the Frame stage's padding mode,
    frame.py:77,120) and the result is a new tensor."""
    wl = windowlen or nfft
    num_frames(x.shape[-1], hop, wl)
    fr = x.unfold(-1, wl, hop)
    if wl < nfft:
        fr = F.pad(fr, (0, nfft - wl))
    return fr
