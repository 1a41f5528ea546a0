"""K4: the fused serving-step kernels, float, split-DFT float and bit-exact
INT.

The counterpart of ``mfcc_tpu.ops.pallas_stream``: one streaming step of
every stream in one CUDA kernel (``csrc/stream_step.cu``) -- pre-emphasis
with the carried previous sample, the per-stream frame alignment by start
offset, the F frames a chunk of C samples can complete, the batch tail and
the new carry as a second output.

  * ``stream_step_float``: carry f32, chunk int16 or f32 -> (S, F, ncep)
    f32.  At ``dft_passes=6`` (the default) on K1's family it runs K1's
    tail (``mfcc_stream_f32_*``), as JAX's ``use_ladder``; otherwise
    (``dft_passes`` 3 or 4: the ``precision="fast"`` step) K5's split-DFT
    tail (``mfcc_stream_r2_*``, ``float_fused``), with the same ingest and
    the same new carry;
  * ``stream_step_int``: carry int32, chunk int16 or int32 -> (S, F, ncep)
    int32, element-exact.

These two keep the JAX functions' signature (``start`` = P - count and
``prev`` with the reset merged by the caller).  The step-level entries
``stream_step_float_state`` and ``stream_step_int_state`` take the stream
state as ``StreamingMFCC`` holds it, (buffer, count, prev) and the reset
flags, and return (feats, mask, new buffer, new count, new prev): the
whole full-chunk step of ``mfcc_tpu.streaming``'s jitted fused step, the
reset merge and the mask and state update included, in one launch of the
same kernel.  The K1- and INT-tail JAX-signature entries launch that
kernel with count = P - start and no reset, and drop the state outputs.

A CUDA tensor launches the kernel (or the wrapper raises), a CPU tensor
takes the plain version, ``stream_step_float_plain`` /
``stream_step_int_plain``: the same function as torch ops (emphasis with
carry, ``[carry | emph]``, a per-row aligned read, ``extract_frames``, then
``fladder.ladder_tail_plain``, ``float_fused.radix2_tail_plain`` resp.
``int_ops.mfcc_int_frames``), and ``stream_step_float_state_plain`` /
``stream_step_int_state_plain``, those inside ``state_step``'s torch
bookkeeping.  ``LAUNCHES`` counts kernel launches per kernel:
``"K4-float"``, ``"K4-split"`` and ``"K4-INT"``; ``STAGED_LAUNCHES`` those
of K4-float and K4-INT that took the staged window (``staged``: the carry
and the chunk the (S, P) carry and (S, C) chunk, rows of unit position
stride back to back, and a tile's streams' rows within a row buffer,
``ROWS_BYTES``), the others the per-point kernels.

Frame slots past a stream's valid count are computed from the zero-padded
signal, by the kernel and the plain version alike; the caller masks them.
Layouts: the carry is (S, P), or (P, S) with ``transposed_state``; the chunk
is (S, C) in the ``"time"`` and ``"stream"`` layouts (they differ only in
where the TPU transposed) and (C, S) in ``"positions"``.  On the card every
layout is read in place through its strides.  The TPU kernel's stream
blocks, lane padding, narrow-lane fallback and the ``STREAM_CHUNK_T`` and
``STREAM_FLADDER`` globals have no counterpart here.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..config import MFCCConfig
from ..kernels import build
from . import fladder, float_fused, framing, int_fused, int_ops

# kernel launches per kernel (never the plain versions)
LAUNCHES = {"K4-float": 0, "K4-split": 0, "K4-INT": 0}
# the K4-float and K4-INT launches that took the staged window
STAGED_LAUNCHES = {"K4-float": 0, "K4-INT": 0}
# the frame slots of a tile and the bytes of one of a block's two row
# buffers, by kernel (stream_step.cu kSlots, kRowsF32, kRowsInt)
TILE_SLOTS = 8
ROWS_BYTES = {"K4-float": 11776, "K4-INT": 21952}

LAYOUTS = ("time", "stream", "positions")


def stream_config_ok(cfg: MFCCConfig) -> bool:
    """The fused steps' geometry, ``pallas_stream_supported`` without the
    backend test: nfft 512, even hop, windowlen == nfft.  The float step
    also needs ``fladder.fladder_config_ok``, the INT step
    ``int_fused.int_config_ok``."""
    return cfg.nfft == 512 and cfg.hop % 2 == 0 and cfg.windowlen == cfg.nfft


def _align16(n: int) -> int:
    return (n + 15) & ~15


def tile_streams(F: int) -> int:
    """The most streams a tile of ``TILE_SLOTS`` slots spans, F slots a
    stream: ceil((TILE_SLOTS - 1) / F) + 1."""
    return min(TILE_SLOTS, -(-(TILE_SLOTS - 1) // F) + 1)


def rows_bytes(n: int, P: int, C: int, in_bytes: int) -> int:
    """Bytes of a row buffer for tiles of n streams (``stream_step.cu``
    ``RowsLayout``): their carry rows (P values of 4 bytes) and their chunk
    rows (C samples of ``in_bytes``), each run copied as the aligned
    16-byte blocks that cover it, and the tile's state (counts, prevs,
    reset words)."""
    return (_align16(4 * P * n + 31) + _align16(in_bytes * C * n + 31)
            + 8 * TILE_SLOTS + 16)


@functools.lru_cache(maxsize=64)     # a serving step asks every step
def staged(kernel: str, F: int, C: int, nfft: int, in_bytes: int,
           strides: tuple) -> bool:
    """Whether a launch of ``kernel`` (``"K4-float"`` or ``"K4-INT"``)
    takes the staged window (the kernels' own test, ``stream_step.cu``
    ``staged``): ``strides`` (carry_s, carry_p, chunk_s, chunk_t, ...) are
    the (S, P) carry's and the (S, C) chunk's, rows of unit position stride
    back to back, and the rows of a tile's streams fit the kernel's row
    buffer (``ROWS_BYTES``); else the per-point kernels."""
    P = nfft - 1
    return (tuple(strides[:4]) == (P, 1, C, 1) and F >= 1
            and rows_bytes(tile_streams(F), P, C, in_bytes)
            <= ROWS_BYTES[kernel])


def frames_per_step(C: int, cfg: MFCCConfig) -> int:
    """F = (C - 1) // hop + 1: the frame slots of a C-sample chunk."""
    return (C - 1) // cfg.hop + 1


def step_frames(signal: torch.Tensor, start: torch.Tensor, cfg: MFCCConfig,
                n_frames: int) -> torch.Tensor:
    """(S, n_frames, nfft) frames of the emphasized ``[carry | chunk]``
    signal (S, P + C): frame f of stream s starts at start[s] + f*hop, and
    positions past the signal read 0 (``start[s]`` in [0, P])."""
    P = cfg.windowlen - 1
    need = (n_frames - 1) * cfg.hop + cfg.windowlen
    pad = max(0, need + P - signal.shape[1])
    aligned = framing.align_rows(F.pad(signal, (0, pad)), start, need)
    return framing.extract_frames(aligned, cfg.nfft, cfg.hop, cfg.windowlen)


def _layout(chunk_layout: str | None) -> str:
    layout = chunk_layout or "time"
    if layout not in LAYOUTS:
        raise ValueError(f"chunk_layout must be one of {LAYOUTS}, got "
                         f"{chunk_layout!r}")
    return layout


def _rows(buffer: torch.Tensor, chunk: torch.Tensor, transposed_state: bool,
          layout: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The carry as (S, P) and the chunk as (S, C), as views."""
    return (buffer.T if transposed_state else buffer,
            chunk.T if layout == "positions" else chunk)


def _check_step(buffer, chunk, start, prev, cfg, transposed_state, layout,
                carry_dtype, chunk_dtypes, what, reset=None,
                lead: str = "start") -> tuple[int, int, int]:
    """Shapes, dtypes and devices of a step's operands (``lead`` names the
    int32 (S,) operand ``start``, or ``count`` for the step-level entries;
    ``reset`` (S,) bool or None); returns (S, P, C)."""
    buf, x = _rows(buffer, chunk, transposed_state, layout)
    P = cfg.windowlen - 1
    if buffer.dim() != 2 or chunk.dim() != 2 or buf.shape[1] != P:
        raise ValueError(f"{what}: carry {tuple(buffer.shape)} and chunk "
                         f"{tuple(chunk.shape)} do not fit P={P}, "
                         f"transposed_state={transposed_state}, layout "
                         f"{layout!r}")
    S, C = x.shape
    vectors = [(lead, start, (torch.int32,)), ("prev", prev, (carry_dtype,))]
    if reset is not None:
        vectors.append(("reset", reset, (torch.bool,)))
    if buf.shape[0] != S or C < 1 or any(tuple(t.shape) != (S,)
                                         for _, t, _ in vectors):
        raise ValueError(f"{what}: {S} streams of {C} samples, carry "
                         f"{tuple(buffer.shape)}, "
                         + ", ".join(f"{n} {tuple(t.shape)}"
                                     for n, t, _ in vectors))
    dev = chunk.device
    for name, t, dtypes in (("carry", buffer, (carry_dtype,)),
                            ("chunk", chunk, chunk_dtypes), *vectors):
        if t.dtype not in dtypes:
            raise TypeError(f"{what}: {name} must be "
                            f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, the chunk "
                             f"on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {dev}")
    return S, P, C


def _strides(buffer, chunk, ncarry, transposed_state, layout) -> tuple:
    """(carry_s, carry_p, chunk_s, chunk_t, ncarry_s, ncarry_p) element
    strides: every layout is read and written in place."""
    bs = buffer.stride()[::-1] if transposed_state else buffer.stride()
    xs = chunk.stride()[::-1] if layout == "positions" else chunk.stride()
    ns = ncarry.stride()[::-1] if transposed_state else ncarry.stride()
    return (*bs, *xs, *ns)


def use_ladder(cfg: MFCCConfig, dft_passes: int) -> bool:
    """The float step's tail, as JAX's ``use_ladder``: K1's at 6 passes on
    K1's family, else K5's split DFT."""
    return dft_passes == 6 and fladder.fladder_config_ok(cfg)


def _new_carry(buffer: torch.Tensor, transposed_state: bool, S: int, P: int
               ) -> torch.Tensor:
    shape = (P, S) if transposed_state else (S, P)
    return torch.empty(shape, dtype=buffer.dtype, device=buffer.device)


def _carry_out(signal: torch.Tensor, C: int, P: int, transposed_state: bool
               ) -> torch.Tensor:
    """The new carry E[C : C+P] in the caller's layout, a fresh tensor."""
    new = signal[:, C: C + P]
    return (new.T if transposed_state else new).contiguous()


def _launch(kernel: str, fn, buffer, chunk, count, reset, prev, S, P, C,
            cfg, ncep, dtype, transposed_state, layout, mid, tail):
    """One launch of K4-float's or K4-INT's kernel (``fn``, counted under
    ``kernel``) on CUDA operands that ``_check_step`` passed, ``reset`` or
    None; ``mid`` the entry's integer arguments between hop and the
    strides, ``tail`` those after them.  Allocates the outputs and returns
    (feats, mask, new carry, new count, new prev)."""
    dev = chunk.device
    n_frames = frames_per_step(C, cfg)
    out = torch.empty((S, n_frames, ncep), dtype=dtype, device=dev)
    mask = torch.empty((S, n_frames), dtype=torch.bool, device=dev)
    ncarry = _new_carry(buffer, transposed_state, S, P)
    ncount = torch.empty((S,), dtype=torch.int32, device=dev)
    nprev = torch.empty((S,), dtype=prev.dtype, device=dev)
    count, prev = count.contiguous(), prev.contiguous()
    strides = _strides(buffer, chunk, ncarry, transposed_state, layout)
    build.launch(fn, dev, buffer.data_ptr(), chunk.data_ptr(),
                 count.data_ptr(),
                 0 if reset is None else reset.contiguous().data_ptr(),
                 prev.data_ptr(), out.data_ptr(), mask.data_ptr(),
                 ncarry.data_ptr(), ncount.data_ptr(), nprev.data_ptr(), S,
                 P, C, n_frames, cfg.hop, *mid, *strides, *tail)
    LAUNCHES[kernel] += 1
    if staged(kernel, n_frames, C, cfg.nfft, chunk.element_size(), strides):
        STAGED_LAUNCHES[kernel] += 1
    return out, mask, ncarry, ncount, nprev


def valid_frames(total: torch.Tensor, cfg: MFCCConfig) -> torch.Tensor:
    """Frames completed by ``total`` buffered samples (floor division, as
    in JAX)."""
    return torch.clamp_min(
        torch.div(total - cfg.windowlen, cfg.hop, rounding_mode="floor") + 1,
        0)


def state_step(step, buffer, chunk, count, prev, reset=None,
               cfg: MFCCConfig = MFCCConfig(), *,
               transposed_state: bool = False,
               chunk_layout: str | None = None):
    """A full-chunk step on the stream state around ``step``, a step of the
    JAX signature (``stream_step_*`` or their plain versions), as torch
    ops: the reset merged into count and prev (``reset`` None: no reset),
    start = P - count, ``step``, then the mask of valid frame slots, the
    new count and the new prev (the chunk's last raw sample) -- the torch
    formulation of ``mfcc_tpu.streaming``'s fused step.  The plain version
    of the step-level kernels, and the split-DFT step's bookkeeping.
    Returns (feats, mask, new buffer, new count, new prev)."""
    layout = _layout(chunk_layout)
    if reset is not None:
        count = torch.where(reset, 0, count)
        prev = torch.where(reset, torch.zeros_like(prev), prev)
    start = (cfg.windowlen - 1 - count).to(torch.int32)
    feats, new_buffer = step(buffer, chunk, start, prev, cfg,
                             transposed_state=transposed_state,
                             chunk_layout=layout)
    positions = layout == "positions"
    C = chunk.shape[0 if positions else 1]
    total = count + C
    n_valid = valid_frames(total, cfg)
    mask = (torch.arange(feats.shape[1], device=chunk.device)[None, :]
            < n_valid[:, None])
    new_count = (total - n_valid * cfg.hop).to(torch.int32)
    last = chunk[-1, :] if positions else chunk[:, -1]
    return (feats, mask, new_buffer, new_count,
            last.to(prev.dtype).contiguous())


# -- float step ----------------------------------------------------------------

def stream_step_float_plain(buffer, chunk, start, prev,
                            cfg: MFCCConfig = MFCCConfig(), *,
                            transposed_state: bool = False,
                            mel_floor: float = 0.0,
                            chunk_layout: str | None = None,
                            dft_passes: int | None = None,
                            operators=None):
    """K4-float as plain torch ops: emphasis in f32 (two roundings, as the
    JAX step), frames from ``[carry | emph]``, then K1's tail in float64
    (``use_ladder``) or K5's split-DFT tail in f32 at ``dft_passes``.
    ``operators`` are the tail's (``fladder.LadderOperators`` or
    ``float_fused.Radix2Operators``).  Returns (feats (S, F, ncep) f32, new
    carry)."""
    passes = 6 if dft_passes is None else dft_passes
    buf, x = _rows(buffer, chunk, transposed_state, _layout(chunk_layout))
    C, P = x.shape[1], cfg.windowlen - 1
    emph = framing.preemphasis(x.to(torch.float32), prev.to(torch.float32))
    signal = torch.cat([buf.to(torch.float32), emph], dim=1)
    frames = step_frames(signal, start, cfg, frames_per_step(C, cfg))
    if use_ladder(cfg, passes):
        ops = operators or fladder.default_operators(cfg, chunk.device)
        feats = fladder.ladder_tail_plain(frames.to(torch.float64), ops, cfg,
                                          mel_floor)
    else:
        ops = operators or float_fused.default_operators(cfg, chunk.device)
        feats = float_fused.radix2_tail_plain(frames, ops, cfg, passes,
                                              mel_floor)
    return feats, _carry_out(signal, C, P, transposed_state)


def _float_launch(buffer, chunk, count, reset, prev, S, P, C, cfg,
                  transposed_state, layout, mel_floor, operators):
    """K4-float's kernel on checked CUDA operands (``_launch``)."""
    dev = chunk.device
    if operators is None:
        ops = fladder.default_operators(cfg, dev)
    else:
        fladder.check_operators(operators, cfg, dev, "K4-float")
        ops = operators
    tables = fladder.tail_tables(ops, cfg, dev)
    lib = build.library()
    fn = (lib.mfcc_stream_f32_i16 if chunk.dtype == torch.int16
          else lib.mfcc_stream_f32_f32)
    out = _launch("K4-float", fn, buffer, chunk, count, reset, prev, S, P,
                  C, cfg, cfg.nceptrums, torch.float32, transposed_state,
                  layout, (cfg.nfft, cfg.nfilters, cfg.nceptrums),
                  (*tables, float(mel_floor)))
    fladder.count_tail(tables)
    return out


def stream_step_float(buffer, chunk, start, prev,
                      cfg: MFCCConfig = MFCCConfig(), *,
                      transposed_state: bool = False, mel_floor: float = 0.0,
                      chunk_layout: str | None = None,
                      dft_passes: int | None = None, operators=None):
    """K4-float, the counterpart of ``pallas_stream.stream_step_float``.

    buffer (S, P) f32 emphasized carry ((P, S) with ``transposed_state``);
    chunk (S, C) int16 or f32 raw samples ((C, S) with
    ``chunk_layout="positions"``); start (S,) int32 = P - count and prev
    (S,) f32 raw previous sample, the reset already merged.
    ``dft_passes`` (None = 6, or 3 or 4): 6 runs K1's tail, 3 and 4 the
    split-DFT tail (``use_ladder``); the split-DFT operators need a zero
    Nyquist mel row (``ValueError`` otherwise).  Returns (feats (S, F,
    ncep) f32, new carry in the buffer's layout), F = (C - 1) // hop + 1.
    A CUDA tensor launches the kernel or raises; a CPU tensor takes
    ``stream_step_float_plain``."""
    layout = _layout(chunk_layout)
    passes = float_fused.check_passes(6 if dft_passes is None
                                      else dft_passes)
    ladder = use_ladder(cfg, passes)
    if not stream_config_ok(cfg) or (passes == 6 and not ladder):
        raise ValueError(f"config outside K4-float's family: {cfg}")
    if not ladder:
        float_fused.radix2_operators(cfg)     # raises where they cannot exist
    S, P, C = _check_step(buffer, chunk, start, prev, cfg, transposed_state,
                          layout, torch.float32,
                          (torch.int16, torch.float32), "K4-float")
    if chunk.device.type == "cpu":
        return stream_step_float_plain(
            buffer, chunk, start, prev, cfg, transposed_state=transposed_state,
            mel_floor=mel_floor, chunk_layout=layout, dft_passes=passes,
            operators=operators)
    if ladder:
        out, _, ncarry, _, _ = _float_launch(
            buffer, chunk, P - start, None, prev, S, P, C, cfg,
            transposed_state, layout, mel_floor, operators)
        return out, ncarry
    if operators is not None:
        float_fused.check_operators(operators, cfg, chunk.device, "K4-split")
    start, prev = start.contiguous(), prev.contiguous()   # (S,): cheap
    n_frames, ncep = frames_per_step(C, cfg), cfg.nceptrums
    out = torch.empty((S, n_frames, ncep), dtype=torch.float32,
                      device=chunk.device)
    ncarry = _new_carry(buffer, transposed_state, S, P)
    args, _buf = float_fused.engine_args(operators, cfg, chunk.device, passes)
    lib = build.library()
    fn = (lib.mfcc_stream_r2_i16 if chunk.dtype == torch.int16
          else lib.mfcc_stream_r2_f32)
    build.launch(fn, chunk.device, buffer.data_ptr(), chunk.data_ptr(),
                 start.data_ptr(), prev.data_ptr(), out.data_ptr(),
                 ncarry.data_ptr(), S, P, C, n_frames, cfg.hop, cfg.nfft,
                 cfg.nfilters, ncep,
                 *_strides(buffer, chunk, ncarry, transposed_state, layout),
                 passes, *args, float(mel_floor))
    LAUNCHES["K4-split"] += 1
    return out, ncarry


def stream_step_float_state_plain(buffer, chunk, count, prev, reset=None,
                                  cfg: MFCCConfig = MFCCConfig(), *,
                                  transposed_state: bool = False,
                                  mel_floor: float = 0.0,
                                  chunk_layout: str | None = None,
                                  operators=None):
    """``stream_step_float_state`` as plain torch ops: ``state_step``
    around ``stream_step_float_plain``."""
    step = functools.partial(stream_step_float_plain, mel_floor=mel_floor,
                             operators=operators)
    return state_step(step, buffer, chunk, count, prev, reset, cfg,
                      transposed_state=transposed_state,
                      chunk_layout=chunk_layout)


def stream_step_float_state(buffer, chunk, count, prev, reset=None,
                            cfg: MFCCConfig = MFCCConfig(), *,
                            transposed_state: bool = False,
                            mel_floor: float = 0.0,
                            chunk_layout: str | None = None,
                            operators=None):
    """One full-chunk float ``StreamingMFCC`` step on K1's tail, in one
    launch of K4-float's kernel.

    buffer, chunk and the layouts as in ``stream_step_float``; count (S,)
    int32 buffered samples and prev (S,) f32, the state as
    ``StreamingMFCC`` holds it; reset (S,) bool flags consumed before the
    chunk, or None for no reset.  Returns (feats (S, F, ncep) f32, mask (S,
    F) bool, new buffer in the buffer's layout, new count (S,) int32, new
    prev (S,) f32).  A CUDA tensor launches the kernel or raises, with
    nothing else on the card but the outputs' allocations; a CPU tensor
    takes ``stream_step_float_state_plain``."""
    layout = _layout(chunk_layout)
    if not (stream_config_ok(cfg) and fladder.fladder_config_ok(cfg)):
        raise ValueError(f"config outside K4-float's family: {cfg}")
    S, P, C = _check_step(buffer, chunk, count, prev, cfg, transposed_state,
                          layout, torch.float32,
                          (torch.int16, torch.float32), "K4-float", reset,
                          "count")
    if chunk.device.type == "cpu":
        return stream_step_float_state_plain(
            buffer, chunk, count, prev, reset, cfg,
            transposed_state=transposed_state, mel_floor=mel_floor,
            chunk_layout=layout, operators=operators)
    return _float_launch(buffer, chunk, count, reset, prev, S, P, C, cfg,
                         transposed_state, layout, mel_floor, operators)


# -- INT step ------------------------------------------------------------------

def stream_step_int_plain(buffer, chunk, start, prev,
                          cfg: MFCCConfig = MFCCConfig(), *,
                          transposed_state: bool = False,
                          chunk_layout: str | None = None):
    """K4-INT as plain torch ops: wrap16 emphasis mod 2^32 on int32, frames
    from ``[carry | emph]``, then the ``int_ops`` chain.  Returns
    (feats (S, F, ncep) int32, new carry)."""
    buf, x = _rows(buffer, chunk, transposed_state, _layout(chunk_layout))
    C, P = x.shape[1], cfg.windowlen - 1
    emph = framing.preemphasis_int(x.to(torch.int32), prev.to(torch.int32),
                                   width=cfg.width)
    signal = torch.cat([buf.to(torch.int32), emph], dim=1)
    frames = step_frames(signal, start, cfg, frames_per_step(C, cfg))
    feats = int_ops.mfcc_int_frames(frames, cfg)
    return feats, _carry_out(signal, C, P, transposed_state)


def _int_launch(buffer, chunk, count, reset, prev, S, P, C, cfg,
                transposed_state, layout):
    """K4-INT's kernel on checked CUDA operands (``_launch``), with K3's
    tables: curve, tw, dtw and the balanced filterbank's schedule."""
    ops = int_fused.int_operators(cfg, chunk.device)
    tail = int_fused.tail_args(cfg, ops)
    lib = build.library()
    fn = (lib.mfcc_stream_int_i16 if chunk.dtype == torch.int16
          else lib.mfcc_stream_int_i32)
    return _launch("K4-INT", fn, buffer, chunk, count, reset, prev, S, P, C,
                   cfg, tail[1], torch.int32, transposed_state, layout, (),
                   (*tail, ops.curve.data_ptr(), ops.tw.data_ptr(),
                    ops.dtw.data_ptr(), ops.fbs.data_ptr()))


def _check_int(cfg: MFCCConfig) -> None:
    if not (stream_config_ok(cfg) and int_fused.int_config_ok(cfg)):
        raise ValueError(f"config outside K4-INT's family: {cfg}")


def stream_step_int(buffer, chunk, start, prev,
                    cfg: MFCCConfig = MFCCConfig(), *,
                    transposed_state: bool = False,
                    chunk_layout: str | None = None):
    """K4-INT, the counterpart of ``pallas_stream.stream_step_int``.

    buffer (S, P) int32 emphasized carry ((P, S) with
    ``transposed_state``); chunk (S, C) int16 or int32 raw samples ((C, S)
    with ``chunk_layout="positions"``), int32 taken as it is (not mod
    2^16); start (S,) int32 = P - count; prev (S,) int32 raw previous
    sample.  Returns (feats (S, F, ncep) int32, new carry).  A CUDA tensor
    launches the kernel or raises; a CPU tensor takes
    ``stream_step_int_plain``."""
    layout = _layout(chunk_layout)
    _check_int(cfg)
    S, P, C = _check_step(buffer, chunk, start, prev, cfg, transposed_state,
                          layout, torch.int32, (torch.int16, torch.int32),
                          "K4-INT")
    if chunk.device.type == "cpu":
        return stream_step_int_plain(
            buffer, chunk, start, prev, cfg,
            transposed_state=transposed_state, chunk_layout=layout)
    out, _, ncarry, _, _ = _int_launch(buffer, chunk, P - start, None, prev,
                                       S, P, C, cfg, transposed_state, layout)
    return out, ncarry


def stream_step_int_state_plain(buffer, chunk, count, prev, reset=None,
                                cfg: MFCCConfig = MFCCConfig(), *,
                                transposed_state: bool = False,
                                chunk_layout: str | None = None):
    """``stream_step_int_state`` as plain torch ops: ``state_step`` around
    ``stream_step_int_plain``."""
    return state_step(stream_step_int_plain, buffer, chunk, count, prev,
                      reset, cfg, transposed_state=transposed_state,
                      chunk_layout=chunk_layout)


def stream_step_int_state(buffer, chunk, count, prev, reset=None,
                          cfg: MFCCConfig = MFCCConfig(), *,
                          transposed_state: bool = False,
                          chunk_layout: str | None = None):
    """One full-chunk INT ``StreamingMFCC`` step in one launch of K4-INT's
    kernel: ``stream_step_float_state``'s operands and outputs with the
    INT state (buffer and prev int32) and chunks int16 or int32 (taken as
    they are).  A CUDA tensor launches the kernel or raises; a CPU tensor
    takes ``stream_step_int_state_plain``."""
    layout = _layout(chunk_layout)
    _check_int(cfg)
    S, P, C = _check_step(buffer, chunk, count, prev, cfg, transposed_state,
                          layout, torch.int32, (torch.int16, torch.int32),
                          "K4-INT", reset, "count")
    if chunk.device.type == "cpu":
        return stream_step_int_state_plain(
            buffer, chunk, count, prev, reset, cfg,
            transposed_state=transposed_state, chunk_layout=layout)
    return _int_launch(buffer, chunk, count, reset, prev, S, P, C, cfg,
                       transposed_state, layout)
