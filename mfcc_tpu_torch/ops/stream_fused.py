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

A CUDA tensor launches the kernel (or the wrapper raises), a CPU tensor
takes the plain version, ``stream_step_float_plain`` /
``stream_step_int_plain``: the same function as torch ops (emphasis with
carry, ``[carry | emph]``, a per-row aligned read, ``extract_frames``, then
``fladder.ladder_tail_plain``, ``float_fused.radix2_tail_plain`` resp.
``int_ops.mfcc_int_frames``).  ``LAUNCHES`` counts kernel launches per
kernel: ``"K4-float"``, ``"K4-split"`` and ``"K4-INT"``.

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

import torch
import torch.nn.functional as F

from ..config import MFCCConfig
from ..kernels import build
from . import fladder, float_fused, framing, int_fused, int_ops

# kernel launches per kernel (never the plain versions)
LAUNCHES = {"K4-float": 0, "K4-split": 0, "K4-INT": 0}

LAYOUTS = ("time", "stream", "positions")


def stream_config_ok(cfg: MFCCConfig) -> bool:
    """The fused steps' geometry, ``pallas_stream_supported`` without the
    backend test: nfft 512, even hop, windowlen == nfft.  The float step
    also needs ``fladder.fladder_config_ok``, the INT step
    ``int_fused.int_config_ok``."""
    return cfg.nfft == 512 and cfg.hop % 2 == 0 and cfg.windowlen == cfg.nfft


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
                carry_dtype, chunk_dtypes, what) -> tuple[int, int, int]:
    """Shapes, dtypes and devices of a step's operands; returns (S, P, C)."""
    buf, x = _rows(buffer, chunk, transposed_state, layout)
    P = cfg.windowlen - 1
    if buffer.dim() != 2 or chunk.dim() != 2 or buf.shape[1] != P:
        raise ValueError(f"{what}: carry {tuple(buffer.shape)} and chunk "
                         f"{tuple(chunk.shape)} do not fit P={P}, "
                         f"transposed_state={transposed_state}, layout "
                         f"{layout!r}")
    S, C = x.shape
    if buf.shape[0] != S or tuple(start.shape) != (S,) \
            or tuple(prev.shape) != (S,) or C < 1:
        raise ValueError(f"{what}: {S} streams of {C} samples, carry "
                         f"{tuple(buffer.shape)}, start {tuple(start.shape)},"
                         f" prev {tuple(prev.shape)}")
    for name, t, dtypes in (("carry", buffer, (carry_dtype,)),
                            ("chunk", chunk, chunk_dtypes),
                            ("start", start, (torch.int32,)),
                            ("prev", prev, (carry_dtype,))):
        if t.dtype not in dtypes:
            raise TypeError(f"{what}: {name} must be "
                            f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
        if t.device != chunk.device:
            raise ValueError(f"{what}: {name} is on {t.device}, the chunk "
                             f"on {chunk.device}")
    if chunk.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got "
                         f"{chunk.device}")
    return S, P, C


def _strides(buffer, chunk, ncarry, transposed_state, layout) -> tuple:
    """(carry_s, carry_p, chunk_s, chunk_t, ncarry_s, ncarry_p) element
    strides: every layout is read and written in place."""
    bs = buffer.stride()[::-1] if transposed_state else buffer.stride()
    xs = chunk.stride()[::-1] if layout == "positions" else chunk.stride()
    ns = ncarry.stride()[::-1] if transposed_state else ncarry.stride()
    return (*bs, *xs, *ns)


def _launch(kernel: str, fn, device: torch.device, *args) -> None:
    build.launch(fn, device, *args)
    LAUNCHES[kernel] += 1


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
    start, prev = start.contiguous(), prev.contiguous()   # (S,): cheap
    n_frames, ncep = frames_per_step(C, cfg), cfg.nceptrums
    out = torch.empty((S, n_frames, ncep), dtype=torch.float32,
                      device=chunk.device)
    ncarry = _new_carry(buffer, transposed_state, S, P)
    lib = build.library()
    head = (buffer.data_ptr(), chunk.data_ptr(), start.data_ptr(),
            prev.data_ptr(), out.data_ptr(), ncarry.data_ptr(), S, P, C,
            n_frames, cfg.hop, cfg.nfft, cfg.nfilters, ncep,
            *_strides(buffer, chunk, ncarry, transposed_state, layout))
    int16 = chunk.dtype == torch.int16
    if ladder:
        ops = operators or fladder.default_operators(cfg, chunk.device)
        fladder.check_operators(ops, cfg, chunk.device, "K4-float")
        fn = lib.mfcc_stream_f32_i16 if int16 else lib.mfcc_stream_f32_f32
        tw = fladder.twiddles(cfg.nfft, chunk.device)
        _launch("K4-float", fn, chunk.device, *head, ops.window.data_ptr(),
                tw.data_ptr(), ops.mel.data_ptr(), ops.dct.data_ptr(),
                ops.band.data_ptr(), float(mel_floor))
    else:
        if operators is not None:
            float_fused.check_operators(operators, cfg, chunk.device,
                                        "K4-split")
        args, _buf = float_fused.engine_args(operators, cfg, chunk.device,
                                             passes)
        fn = lib.mfcc_stream_r2_i16 if int16 else lib.mfcc_stream_r2_f32
        _launch("K4-split", fn, chunk.device, *head, passes, *args,
                float(mel_floor))
    return out, ncarry


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
    if not (stream_config_ok(cfg) and int_fused.int_config_ok(cfg)):
        raise ValueError(f"config outside K4-INT's family: {cfg}")
    S, P, C = _check_step(buffer, chunk, start, prev, cfg, transposed_state,
                          layout, torch.int32, (torch.int16, torch.int32),
                          "K4-INT")
    if chunk.device.type == "cpu":
        return stream_step_int_plain(
            buffer, chunk, start, prev, cfg,
            transposed_state=transposed_state, chunk_layout=layout)
    start, prev = start.contiguous(), prev.contiguous()   # (S,): cheap
    ops = int_fused.int_operators(cfg, chunk.device)
    n_frames = frames_per_step(C, cfg)
    tail = int_fused.tail_args(cfg, ops)
    out = torch.empty((S, n_frames, tail[1]), dtype=torch.int32,
                      device=chunk.device)
    ncarry = _new_carry(buffer, transposed_state, S, P)
    lib = build.library()
    fn = (lib.mfcc_stream_int_i16 if chunk.dtype == torch.int16
          else lib.mfcc_stream_int_i32)
    _launch("K4-INT", fn, chunk.device, buffer.data_ptr(), chunk.data_ptr(),
            start.data_ptr(), prev.data_ptr(), out.data_ptr(),
            ncarry.data_ptr(), S, P, C, n_frames, cfg.hop,
            *_strides(buffer, chunk, ncarry, transposed_state, layout),
            *tail, *int_fused.table_ptrs(ops))
    return out, ncarry
