"""Stateful multi-stream chunked streaming API on torch tensors.

The counterpart of ``mfcc_tpu.streaming``.  The reference is a streaming
device: samples trickle in, the Frame stage's ring buffer re-reads
windowlen-stepsize overlap samples per frame (mfcc/core/frame.py:86-114),
Preemph carries one previous sample (preemph.py:20-27), and the host can
soft-reset the pipeline mid-stream by sending 0x80000000
(software/main.c:21-34).  Here the per-stream state is an explicit tuple of
tensors the caller owns (checkpointable), and a chunk step is one call:

    sm = StreamingMFCC()                  # on the card
    state = sm.init(n_streams)
    feats, mask, state = sm.step(chunks, state, reset=flags)

Invariant: the carry buffer holds, right-aligned, exactly the emphasized
samples from the next unemitted frame's start onward (count <= nfft-1), so
chunked processing equals whole-signal batch processing for ANY chunking.

Routing, as ``mfcc_tpu.streaming`` routes:

  * full-chunk steps (``lengths=None``) of a config in the fused family go
    to K4 (``ops/stream_fused.py``): the INT step for ``int_path=True``, the
    float step for ``method="dft"``, float32, ``precision="highest"`` and a
    config in K1's family.  On the card such a step is one kernel launch
    (``stream_step_{int,float}_state``: the reset merge, the features, the
    new carry, the mask, the new count and prev), as the JAX package's
    jitted fused step is one dispatch;
  * full-chunk steps under ``precision="fast"`` (``method="dft"``, float32,
    a zero Nyquist mel row) go to the split-DFT step at 3 passes
    (``stream_step_float(dft_passes=3)``, K5's tail, inside
    ``stream_fused.state_step``'s torch bookkeeping) for CUDA tensors, and
    to the "highest" chain for CPU tensors, as ``mfcc_tpu.streaming`` runs
    its chain off the TPU;
  * ``precision="f64ish"`` runs every step, flush steps included, through
    the chain step with f32 emphasis and ``f64ish.mfcc_frames_f64ish`` as
    its features (K7-frames on the card once per step, for a config in
    K7's family), as ``mfcc_tpu.streaming`` does; the fused step is not
    used;
  * flush steps (``lengths`` given) and every other config take the chain:
    ``_chunk_step_batch`` and the features function (the INT frames kernel
    K3, or the ``float_ops`` chain, with ``precision="split"``, ``"high"``,
    ``"default"`` and ``"bf16"`` as given).

The JAX package's barrel shifter (``_barrel_align``) is a TPU device: here
the per-row alignment is one indexed read.  Nothing is compiled per chunk
width, so ``CHUNK_WIDTH_WARN`` has no counterpart.  ``save_state`` /
``load_state`` use the npz format of the JAX package's fallback, so a carry
saved there resumes here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .config import MFCCConfig
from .ops import (f64ish, fladder, float_ops, framing, int_fused, int_ops,
                  stream_fused)
from .pipeline import check_precision, resolve_device


class StreamState(NamedTuple):
    """Per-stream carry (checkpoint/restore = save/load it)."""
    buffer: torch.Tensor   # (S, nfft-1) right-aligned emphasized samples
    count: torch.Tensor    # (S,) int32 valid samples in buffer (from the right)
    prev: torch.Tensor     # (S,) previous raw sample (pre-emphasis carry)

    @classmethod
    def from_numpy(cls, arrays, device) -> "StreamState":
        """A state from numpy arrays (a mapping with the field names, e.g.
        an ``np.load`` of a saved state), as tensors on ``device``."""
        return cls(*(torch.as_tensor(np.asarray(arrays[f]), device=device)
                     for f in cls._fields))


def init_state(n_streams: int, cfg: MFCCConfig = MFCCConfig(),
               dtype: torch.dtype = torch.float32, device=None
               ) -> StreamState:
    """A zero carry for ``n_streams`` streams on ``device``: ``None`` is the
    card, and raises on a host without one, naming ``device="cpu"``."""
    device = resolve_device(device, "init_state")
    return StreamState(
        buffer=torch.zeros((n_streams, cfg.windowlen - 1), dtype=dtype,
                           device=device),
        count=torch.zeros((n_streams,), dtype=torch.int32, device=device),
        prev=torch.zeros((n_streams,), dtype=dtype, device=device),
    )


def max_frames_per_chunk(chunk_size: int, cfg: MFCCConfig) -> int:
    """Static bound on frames a chunk can complete: carry holds at most
    nfft-1 samples, so at most (nfft-1 + chunk - nfft)//hop + 1."""
    return stream_fused.frames_per_step(chunk_size, cfg)


def _chunk_step_batch(chunks, state: StreamState, reset, cfg: MFCCConfig,
                      emphasize, dtype, lengths=None):
    """One chunk step over (S, C) batched chunks: consumes per-stream reset
    flags (the reset applies BEFORE the chunk's samples), emits every frame
    slot plus a validity mask, and right-aligns the carry.  ``lengths``
    (S,) gives each stream's real samples (clipped to [0, C]; the flush
    path), None means full chunks."""
    S, C = chunks.shape
    P = cfg.windowlen - 1
    F = max_frames_per_chunk(C, cfg)
    count = torch.where(reset, 0, state.count)
    prev = torch.where(reset, torch.zeros_like(state.prev), state.prev)
    emph = emphasize(chunks, prev).to(dtype)
    buf = torch.cat([state.buffer, emph], dim=1)             # (S, P + C)
    frames = stream_fused.step_frames(buf, (P - count).to(torch.int32), cfg,
                                      F)
    if lengths is None:
        total = count + C
        new_buffer = buf[:, C: C + P].contiguous()
        new_prev = chunks[:, -1].to(state.prev.dtype).contiguous()
    else:
        L = torch.clamp(lengths.to(torch.int32), 0, C)
        total = count + L
        new_buffer = framing.align_rows(buf, L, P)
        li = torch.clamp_min(L - 1, 0).to(torch.int64)
        last = torch.gather(chunks, 1, li[:, None])[:, 0]
        new_prev = torch.where(L > 0, last.to(prev.dtype), prev
                               ).to(state.prev.dtype)
    n_valid = stream_fused.valid_frames(total, cfg)
    mask = (torch.arange(F, device=chunks.device)[None, :]
            < n_valid[:, None])
    new_count = (total - n_valid * cfg.hop).to(torch.int32)
    return frames, mask, StreamState(new_buffer, new_count, new_prev)


class StreamingMFCC:
    """Multi-stream streaming front-end.

    float path by default; ``int_path=True`` gives the bit-exact
    fixed-point pipeline (int32 state and arithmetic).
    """

    def __init__(self, cfg: MFCCConfig = MFCCConfig(), *,
                 int_path: bool = False, method: str = "dft",
                 precision: str = "highest",
                 dtype: torch.dtype = torch.float32, device=None,
                 transposed_state: bool = False, mel_floor: float = 0.0,
                 transposed_chunks: bool = False):
        """``device``: where the state lives and the steps run; ``None`` is
        the card (``"cuda"``) and raises on a host without one;
        ``device="cpu"`` runs the plain torch versions on the host.

        ``precision``: ``"highest"``; ``"fast"``, whose full-chunk steps
        on the card run the 3-pass split-DFT step (the JAX package's fast
        serving mode), flush steps and the CPU the "highest" chain;
        ``"f64ish"``, every step on the chain with f64ish features (K7-frames
        on the card; the state is f32 and ``dtype`` and ``mel_floor`` are
        ignored, as in JAX); ``"split"``, every step on the chain with a
        split-bf16 DFT matmul; or ``"high"``, ``"default"`` and ``"bf16"``,
        every step on the chain at that precision (bf16 limbs on the card,
        full float32 on the CPU; see ``ops.float_ops``).

        ``transposed_state=True`` stores the carry buffer (P, S);
        ``transposed_chunks=True`` makes ``step`` take chunks (C, S).  The
        kernel reads either layout in place; the chain transposes at its
        boundary.

        ``mel_floor``: float-path clamp of the mel spectrum before log2.
        The default 0.0 keeps the notebook spec: digital silence gives
        -inf/NaN cepstra.  1.0 is the float analogue of the RTL's 0 -> 1
        clamp (the FeatureServer float path's default).  Ignored on the
        INT path."""
        self.cfg = cfg
        self.int_path = int_path
        self.method = method
        self.precision = precision
        self.mel_floor = float(mel_floor)
        self.transposed_state = transposed_state
        self.transposed_chunks = transposed_chunks
        self.device = resolve_device(device, "StreamingMFCC")
        check_precision(precision)
        if int_path:
            self.dtype = torch.int32
        else:
            self.dtype = torch.float32 if precision == "f64ish" else dtype

        # the route of full steps; "split" (fast mode's split-DFT step) only
        # off the CPU
        self._route = "chain"
        fused_geometry = stream_fused.stream_config_ok(cfg)
        if int_path:
            self._emphasize = functools.partial(framing.preemphasis_int,
                                                width=cfg.width)
            if int_fused.int_config_ok(cfg):
                self._features = functools.partial(
                    int_fused.mfcc_int_fused_frames, cfg=cfg)
                if fused_geometry:
                    self._route = "fused"
            else:
                self._features = functools.partial(int_ops.mfcc_int_frames,
                                                   cfg=cfg)
        else:
            self._emphasize = framing.preemphasis
            if precision == "f64ish":
                self._features = functools.partial(
                    f64ish.mfcc_frames_f64ish, cfg=cfg)
            else:
                # precision="fast" is a fused-kernel dial; the chain runs
                # the "highest" chain so a fast-mode stream is never less
                # accurate
                self._features = functools.partial(
                    float_ops.mfcc_frames, cfg=cfg, method=method,
                    precision="highest" if precision == "fast" else precision,
                    dtype=dtype, mel_floor=self.mel_floor)
            if fused_geometry and method == "dft" and dtype == torch.float32:
                if precision == "highest" and fladder.fladder_config_ok(cfg):
                    self._route = "fused"
                elif (precision == "fast"
                      and fladder.nyquist_mel_row_zero(cfg)):
                    self._route = "split"

    # -- state ---------------------------------------------------------------

    def init(self, n_streams: int) -> StreamState:
        st = init_state(n_streams, self.cfg, self.dtype, self.device)
        if self.transposed_state:
            st = st._replace(buffer=st.buffer.T.contiguous())
        return st

    def _as_tensor(self, x, dtype=None) -> torch.Tensor:
        """A tensor must lie on this object's device (nothing is moved
        behind the caller's back); numpy arrays and lists are put there."""
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(
                    f"input is on {x.device} but the stream runs on "
                    f"{self.device}: move one of them with .to()")
        else:
            x = torch.as_tensor(np.asarray(x), device=self.device)
        return x if dtype is None else x.to(dtype)

    # -- one step -------------------------------------------------------------

    def step(self, chunks, state: StreamState, reset=None, lengths=None):
        """Process one chunk per stream.

        chunks:  (S, C) raw samples -- (C, S) under ``transposed_chunks``
                 -- any C >= 1
        reset:   (S,) bool -- soft-reset flags consumed before the chunk
        lengths: (S,) int -- number of REAL samples per chunk (default C);
                 trailing padding is ignored by the carry and the frame
                 mask, so a final partial chunk can be flushed.
        returns (features (S, F_max, ncep), mask (S, F_max), new_state);
        mask[s, k] marks which of the F_max frame slots are real frames.
        """
        chunks = self._as_tensor(chunks)
        fused = lengths is None and (
            self._route == "fused"
            or (self._route == "split" and chunks.device.type != "cpu"))
        if not (chunks.dtype == torch.int16 and fused):
            # the kernel takes the int16 wire dtype as it is; every other
            # path computes in the state dtype
            chunks = chunks.to(self.dtype)
        if reset is not None:
            reset = self._as_tensor(reset, torch.bool)
        if fused:
            return self._fused_step(chunks, state, reset)
        if reset is None:
            S = chunks.shape[1 if self.transposed_chunks else 0]
            reset = torch.zeros((S,), dtype=torch.bool, device=self.device)
        if lengths is not None:
            lengths = self._as_tensor(lengths, torch.int32)
        return self._chain_step(chunks, state, reset, lengths)

    def _fused_step(self, chunks, state, reset):
        """A full-chunk step of the fused routes: one launch of K4-float's
        or K4-INT's kernel that also merges the reset and updates the state
        (``stream_step_*_state``; their plain versions on the CPU), or the
        split-DFT step inside ``stream_fused.state_step``'s torch
        bookkeeping."""
        kw = dict(transposed_state=self.transposed_state,
                  chunk_layout=("positions" if self.transposed_chunks
                                else "time"))
        args = (state.buffer, chunks, state.count, state.prev, reset,
                self.cfg)
        if self._route == "split":
            step = functools.partial(stream_fused.stream_step_float,
                                     mel_floor=self.mel_floor, dft_passes=3)
            out = stream_fused.state_step(step, *args, **kw)
        elif self.int_path:
            out = stream_fused.stream_step_int_state(*args, **kw)
        else:
            out = stream_fused.stream_step_float_state(
                *args, mel_floor=self.mel_floor, **kw)
        return out[0], out[1], StreamState(*out[2:])

    def _chain_step(self, chunks, state, reset, lengths):
        if self.transposed_chunks:
            chunks = chunks.T
        if self.transposed_state:
            state = state._replace(buffer=state.buffer.T)
        frames, mask, new_state = _chunk_step_batch(
            chunks, state, reset, self.cfg, self._emphasize, self.dtype,
            lengths)
        if self.transposed_state:
            new_state = new_state._replace(
                buffer=new_state.buffer.T.contiguous())
        return self._features(frames.contiguous()), mask, new_state

    # -- whole signals --------------------------------------------------------

    def drain(self, state: StreamState):
        """Flush the carry: zero-pad each stream's residual samples so every
        frame that contains at least one real sample is emitted (the frames
        a batch run over the zero-padded signal would produce).  Returns
        (features, mask, new_state); mask excludes all-padding frames."""
        cfg = self.cfg
        S = state.count.shape[0]
        shape = (cfg.nfft, S) if self.transposed_chunks else (S, cfg.nfft)
        pad = torch.zeros(shape, dtype=state.buffer.dtype, device=self.device)
        feats, mask, new_state = self.step(pad, state)
        F = feats.shape[1]
        keep = ((torch.arange(F, device=self.device) * cfg.hop)[None, :]
                < state.count[:, None])
        return feats, mask & keep, new_state

    def process(self, audio, chunk_size: int, reset_at: dict | None = None,
                drain: bool = False):
        """Convenience: run a whole (S, T) signal through chunked steps and
        return the concatenated valid features per stream (a list of numpy
        arrays) and the final state.

        ALL T samples are consumed: the final T % chunk_size samples are fed
        as a zero-padded chunk with an explicit length, so the result equals
        the batch pipeline on the full signal.  With ``drain=True`` the
        residual partial frame is also flushed (zero-padded).

        reset_at: {chunk_index: (S,) bool} optional reset schedule."""
        audio = self._as_tensor(audio)
        S, T = audio.shape
        state = self.init(S)
        outs = [[] for _ in range(S)]

        def collect(feats, mask):
            feats, mask = feats.cpu().numpy(), mask.cpu().numpy()
            for s in range(S):
                outs[s].append(feats[s][mask[s]])

        n_chunks = -(-T // chunk_size) if T else 0
        for ci in range(n_chunks):
            chunk = audio[:, ci * chunk_size:(ci + 1) * chunk_size]
            lengths = None
            if chunk.shape[1] < chunk_size:       # final partial chunk
                lengths = torch.full((S,), chunk.shape[1], dtype=torch.int32,
                                     device=self.device)
                padded = chunk.new_zeros((S, chunk_size))
                padded[:, : chunk.shape[1]] = chunk
                chunk = padded
            reset = (reset_at or {}).get(ci)
            if self.transposed_chunks:
                chunk = chunk.T
            feats, mask, state = self.step(chunk, state, reset,
                                           lengths=lengths)
            collect(feats, mask)
        if drain:
            feats, mask, state = self.drain(state)
            collect(feats, mask)
        return [np.concatenate(o) if o else np.zeros((0, self.cfg.nceptrums))
                for o in outs], state


# -- Checkpoint / resume --------------------------------------------------------
#
# The reference has no checkpointing: device state is <= 1 frame of audio and
# recovery is "reset and resend".  Here the carry IS the checkpoint; these
# helpers persist it in the npz format that the JAX package writes when orbax
# is absent, so the two packages read each other's carries.

def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state: StreamState) -> None:
    np.savez(_npz_path(path), **{f: getattr(state, f).cpu().numpy()
                                 for f in state._fields})


def load_state(path: str, device=None) -> StreamState:
    """A saved state on ``device`` (``None`` is the card, as for the
    entry points)."""
    device = resolve_device(device, "load_state")
    with np.load(_npz_path(path)) as npz:
        return StreamState.from_numpy(npz, device)
