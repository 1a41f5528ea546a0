"""K1: the fused float MFCC kernel of the float batch path, and the one
launch of every batch kernel on the FP64 tail.

The counterpart of ``mfcc_tpu.ops.pallas_fladder`` (the radix-2 ladder
kernel): (S, T) int16 or f32 audio -> (S, F, nceptrums) f32, with
pre-emphasis, framing, window * 1/nfft, an FFT, power on bins [0, nfft/2),
the mel product, an optional ``mel_floor``, log2 and the DCT product in one
CUDA kernel.

``mfcc_float_ladder`` is the wrapper: a CUDA tensor launches the kernel (or
the wrapper raises), a CPU tensor takes ``mfcc_float_ladder_plain``, the
same function as a chain of torch ops.  ``LAUNCHES`` counts kernel
launches.

K1, K6, K1-Kaldi, K7 and K7-frames are one persistent walk over frames,
``tail_walk`` in ``csrc/fladder.cu``, with four ingests (``FPGA``,
``KALDI``, ``F64ISH``, ``F64ISH_FRAMES``); ``launch_tail`` is their one
launch (checks, operators, output, tables) behind one C entry,
``mfcc_tail_walk``.

Kaldi's recipe (``config.KaldiConfig``) runs on the walk with Kaldi's
ingest: ``mfcc_kaldi_ladder`` from audio and ``mfcc_kaldi_frames`` from
frames, their plain versions ``mfcc_kaldi_ladder_plain`` and
``mfcc_kaldi_frames_plain`` (the recipe's chain, on any device and any
config of the recipe), family ``kaldi_config_ok``, tables
``kaldi_operators``, and launches counted in ``KALDI_LAUNCHES``.

Every kernel on the shared FP64 tail (the walk's and K4-float,
``csrc/fladder_stages.cuh`` ``ladder_tail``) sums the mel bank
on the balanced schedule that ``mel_schedule`` builds: the bank's nonzero
terms cut evenly over a warp's 32 lanes, where a lane per filter would run
the widest band's length.  ``tail_tables`` derives it from the operators'
mel at launch (``schedule_of``, cached per bank and built again when the
bank changes in place); ``MEL_SCHEDULE_LAUNCHES`` counts the tail launches
that ran it.

Both compute the interior in float64 and round to f32 once, at the output
(the TPU kernel stays in f32 because the TPU has no f64).  An f32 FFT
resolves a frame's quiet low mel bands only to ~1e-7 of its energy, and
log2 amplifies that to within 1.5x of the 5e-4 gate on long inputs; see
the note in ``csrc/fladder.cu``.  The operators are therefore float64, in natural bin
order; the Pallas kernel's sigma/regroup permutations are a TPU layout and
are not carried over.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import MFCCConfig
from .. import tables
from ..kernels import build
from . import framing

LAUNCHES = 0     # kernel launches by mfcc_float_ladder (never the plain path)
KALDI_LAUNCHES = 0   # launches with Kaldi's ingest (mfcc_kaldi_*)
# launches of any kernel on the FP64 tail that summed the mel bank on the
# balanced schedule (steps > 0), whichever entry launched it
MEL_SCHEDULE_LAUNCHES = 0


class LadderOperators(NamedTuple):
    """K1's operators on one device."""
    window: torch.Tensor   # (nfft,) float64 Hamming window * (1/nfft)
    mel: torch.Tensor      # (nfft/2, nfilters) float64, Nyquist row dropped
    dct: torch.Tensor      # (nfilters, nceptrums) float64
    band: torch.Tensor     # (nfilters, 2) int32 mel_bands(mel)


# The balanced mel schedule (csrc/fladder_stages.cuh): lanes a warp, the
# int32 words of one entry {float64 weight, power byte offset, slot byte
# offset}, and the table's capacity, a step a lane per kMelBinsPerStep bins
# of the power row (nfft/32 steps: a triangular bank holds at most two
# terms a bin, 2 * nfft/2 terms over 32 lanes).
MEL_LANES = 32
MEL_ENTRY_WORDS = 4
MEL_BINS_PER_STEP = 16


def mel_steps_fit(steps: int, nbins: int) -> bool:
    """Whether a schedule of ``steps`` entries a lane fits the table of a
    tail over ``nbins`` = nfft/2 power bins: the predicate of the kernels'
    ``mel_steps`` (fladder_stages.cuh)."""
    return 1 <= steps <= nbins // MEL_BINS_PER_STEP


def mel_schedule(mel: np.ndarray, cap: int | None = None
                 ) -> np.ndarray | None:
    """The balanced mel schedule of the (nbins, nfilters) float64 mel bank
    ``mel``, as every kernel on the FP64 tail reads it: the nonzero terms
    (filter j, bin k), filter-major with ascending bins, cut into 32 runs
    of L = ceil(terms / 32), lane l taking run l.  Returns int32 words: L x
    32 entries of 4 words {weight (float64), 8k, slot}, entry i of lane l
    at (i*32 + l)*4, then one gather word a filter; None where the bank
    has no term or its schedule does not fit the table (``mel_steps_fit``;
    ``cap``: a table of that many steps a lane instead, a kernel's own) or
    its segments the warp's row.

    A segment is a run's stretch of one filter.  At its last term the
    lane stores its sum to the segment's slot, a byte offset in the second
    half of the warp's row (2 * nbins doubles), past the power, and starts
    the next segment's sum from 0 (slot 0: no store); entries past a
    lane's run are 0.  Filter j's segments take consecutive slots in bin
    order; its gather word is the first one's byte offset | their count <<
    16 (0 for a filter with no term).  Every segment sums its own terms
    from 0, never as a difference of running sums: in float64 that would
    cancel where a loud filter precedes a quiet one in a lane."""
    mel = np.asarray(mel, np.float64)
    nbins, nf = mel.shape
    f, k = np.nonzero(mel.T)                  # filter-major, bins ascending
    terms = len(f)
    L = -(-terms // MEL_LANES)
    if not (mel_steps_fit(L, nbins) if cap is None else 1 <= L <= cap):
        return None
    idx = np.arange(terms)
    lane, step = idx // L, idx % L
    last = np.ones(terms, bool)               # a segment's last term
    last[:-1] = (f[1:] != f[:-1]) | (lane[1:] != lane[:-1])
    seg = np.cumsum(last) - last
    base = nbins                              # the slots' first double
    if base + int(last.sum()) > 2 * nbins:    # the row holds 2 * nbins
        return None
    ent = np.zeros((L, MEL_LANES), [("w", "<f8"), ("k", "<i4"), ("s", "<i4")])
    ent["w"][step, lane] = mel[k, f]
    ent["k"][step, lane] = 8 * k
    ent["s"][step, lane] = np.where(last, 8 * (base + seg), 0)
    seg_filter = f[last]                      # each segment's filter
    first = np.searchsorted(seg_filter, np.arange(nf))
    count = np.bincount(seg_filter, minlength=nf)
    gather = np.where(count > 0, 8 * (base + first) + (count << 16), 0)
    return np.concatenate([ent.view(np.int32).reshape(-1),
                           gather.astype(np.int32)])


# the mel schedules of the banks the kernels were given, per the bank's
# (device, address, shape, strides), with the _version it was built at;
# each entry keeps its bank alive, so the address is not reused while the
# entry stands.  _SCHEDULE_LAST is the entry last returned, found by the
# bank's identity first (a serving step's cached operators).
_SCHEDULE_CACHE: dict = {}
_SCHEDULE_LAST: tuple = (None, None, None, 0)


def schedule_of(mel: torch.Tensor) -> tuple[torch.Tensor | None, int]:
    """The ``mel_schedule`` of the (nbins, nfilters) float64 bank ``mel``
    as an int32 tensor on its device, and its steps a lane; (None, 0)
    where the bank has none (the lane-per-filter loop).  Cached per bank,
    and built again whenever the bank has changed in place (at every call
    for an inference tensor, which keeps no version)."""
    global _SCHEDULE_LAST
    version = None if mel.is_inference() else mel._version
    hit = _SCHEDULE_LAST
    if hit[0] is mel and version is not None and hit[1] == version:
        return hit[2], hit[3]
    key = (mel.device, mel.data_ptr(), tuple(mel.shape), mel.stride())
    hit = _SCHEDULE_CACHE.get(key)
    if hit is None or version is None or hit[1] != version:
        _SCHEDULE_CACHE.pop(key, None)
        if len(_SCHEDULE_CACHE) >= 16:
            _SCHEDULE_CACHE.pop(next(iter(_SCHEDULE_CACHE)))
        words = mel_schedule(mel.detach().cpu().numpy())
        if words is None:
            sched, steps = None, 0
        else:
            sched = torch.as_tensor(words, device=mel.device)
            steps = ((len(words) - mel.shape[1])
                     // (MEL_LANES * MEL_ENTRY_WORDS))
        hit = _SCHEDULE_CACHE[key] = (mel, version, sched, steps)
    _SCHEDULE_LAST = hit
    return hit[2], hit[3]


@functools.lru_cache(maxsize=None)
def nyquist_mel_row_zero(cfg: MFCCConfig) -> bool:
    """Whether bin nfft/2 carries no mel weight, so that dropping it (as
    the fused kernels do) changes nothing."""
    mel64 = tables.float_mel_matrix(cfg.samplerate, cfg.nfft, cfg.nfilters)
    return not mel64[cfg.nfft // 2].any()


def fladder_config_ok(cfg: MFCCConfig) -> bool:
    """K1's config family, the same predicate as
    ``mfcc_tpu.ops.pallas_fladder.pallas_fladder_config_ok``: nfft in
    {256, 512, 1024}, even hop, full-length windows, and a zero Nyquist mel
    row (the kernel computes bins [0, nfft/2) only)."""
    return (cfg.recipe == "fpga" and cfg.nfft in (256, 512, 1024)
            and cfg.hop % 2 == 0 and cfg.windowlen == cfg.nfft
            and nyquist_mel_row_zero(cfg))


def kaldi_config_ok(cfg: MFCCConfig) -> bool:
    """The Kaldi instantiation's family: Kaldi's recipe at nfft 256, 512
    or 1024 with an even frame length (the ingest loads sample pairs)."""
    return (cfg.recipe == "kaldi" and cfg.nfft in (256, 512, 1024)
            and cfg.windowlen % 2 == 0 and cfg.nfilters <= cfg.nfft // 2)


def check_kaldi_dials(method: str, precision: str, dtype: torch.dtype,
                      mel_floor: float) -> None:
    """Raise unless the dials are the ones Kaldi's recipe runs at: the
    recipe states its own floor (FLT_EPSILON) and its FP64 tail."""
    if (method != "dft" or precision != "highest"
            or dtype != torch.float32 or mel_floor):
        raise ValueError(
            "Kaldi's recipe runs with method=\"dft\", precision=\"highest\", "
            "float32 and no mel_floor (it floors at FLT_EPSILON itself)")


def kaldi_operators(cfg: MFCCConfig) -> tuple[np.ndarray, ...]:
    """Kaldi's tables as the tail reads them, float64: the povey window
    zero-padded to nfft (no 1/nfft: Kaldi's power is unscaled), the mel
    banks over bins [0, nfft/2), and the DCT with the lifter and ln 2
    folded in (the tail's log2 times ln 2 is Kaldi's natural log)."""
    win = np.zeros(cfg.nfft)
    win[: cfg.windowlen] = tables.povey_window(cfg.windowlen)
    mel = tables.kaldi_mel_matrix(cfg.samplerate, cfg.nfft, cfg.nfilters,
                                  cfg.low_freq, cfg.high_freq)
    dct = tables.kaldi_dct_matrix(cfg.nfilters, cfg.nceptrums,
                                  cfg.cepstral_lifter) * np.log(2.0)
    return win, mel, np.ascontiguousarray(dct)


def fladder_operators(cfg: MFCCConfig) -> tuple[np.ndarray, ...]:
    """(window/nfft, mel without the Nyquist row, dct) as float64 arrays;
    ``kaldi_operators`` for Kaldi's recipe."""
    if cfg.recipe == "kaldi":
        return kaldi_operators(cfg)
    if not nyquist_mel_row_zero(cfg):
        raise ValueError("K1 needs a zero Nyquist mel row")
    win = tables.float_window(cfg.nfft) / cfg.nfft
    mel = tables.float_mel_matrix(cfg.samplerate, cfg.nfft, cfg.nfilters)
    dct = tables.dct2_ortho_matrix(cfg.nfilters)[:, : cfg.nceptrums]
    return (win, np.ascontiguousarray(mel[: cfg.nfft // 2]),
            np.ascontiguousarray(dct))


@functools.lru_cache(maxsize=None)
def default_operators(cfg: MFCCConfig, device: torch.device
                      ) -> LadderOperators:
    """``fladder_operators(cfg)`` and the mel band limits as tensors,
    cached per (cfg, device)."""
    win, mel, dct = (torch.as_tensor(a, device=device)
                     for a in fladder_operators(cfg))
    return LadderOperators(win, mel, dct, mel_bands(mel))


@functools.lru_cache(maxsize=None)
def twiddles(nfft: int, device: torch.device) -> torch.Tensor:
    """(nfft/2, 2) float64 [Re, Im] of exp(-2*pi*i*k/nfft)."""
    ang = 2.0 * np.pi * np.arange(nfft // 2) / nfft
    return torch.as_tensor(np.stack([np.cos(ang), -np.sin(ang)], axis=1),
                           device=device)


def mel_bands(mel: torch.Tensor) -> torch.Tensor:
    """(nfilters, 2) int32 [lo, hi): each mel column is zero outside rows
    [lo, hi), so the kernel sums only there (same sum as the dense product:
    the skipped terms are exact zeros).  An all-zero column gives the whole
    range.  Computed on ``mel``'s device without a host sync."""
    nz = (mel != 0).to(torch.int32)
    lo = nz.argmax(dim=0)
    hi = mel.shape[0] - nz.flip(0).argmax(dim=0)
    return torch.stack([lo, hi], dim=1).to(torch.int32).contiguous()


def _resolve(operators, cfg, device) -> LadderOperators:
    if operators is None:
        return default_operators(cfg, device)
    return operators


def check_operators(ops: LadderOperators, cfg: MFCCConfig,
                    device: torch.device, what: str) -> None:
    """Raise unless the operators are the contiguous float64 (int32 band)
    tensors of ``cfg``'s shapes on ``device`` that the kernels read."""
    nbins, nfilters, ncep = cfg.nfft // 2, cfg.nfilters, cfg.nceptrums
    for name, t, shape, dtype in (
            ("window", ops.window, (cfg.nfft,), torch.float64),
            ("mel", ops.mel, (nbins, nfilters), torch.float64),
            ("dct", ops.dct, (nfilters, ncep), torch.float64),
            ("band", ops.band, (nfilters, 2), torch.int32)):
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{what} operator {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {device}")


def tail_tables(ops: LadderOperators, cfg: MFCCConfig,
                device: torch.device) -> tuple:
    """The table arguments of every C entry on the FP64 tail, in their
    order: window, twiddles, mel, dct, band, and the schedule of the
    operators' mel (``schedule_of``) with its steps a lane (a null schedule
    and 0 steps keep the lane-per-filter loop)."""
    sched, steps = schedule_of(ops.mel)
    return (ops.window.data_ptr(), twiddles(cfg.nfft, device).data_ptr(),
            ops.mel.data_ptr(), ops.dct.data_ptr(), ops.band.data_ptr(),
            None if sched is None else sched.data_ptr(), steps)


def count_tail(args: tuple) -> None:
    """Count a launch with the ``tail_tables`` ``args`` in
    MEL_SCHEDULE_LAUNCHES where it ran the balanced schedule."""
    global MEL_SCHEDULE_LAUNCHES
    MEL_SCHEDULE_LAUNCHES += args[-1] > 0


def ladder_tail_plain(frames64: torch.Tensor, ops: LadderOperators,
                      cfg: MFCCConfig, mel_floor: float = 0.0
                      ) -> torch.Tensor:
    """The kernels' tail as plain torch ops, on (..., F, nfft) float64
    pre-emphasized frames: window * 1/nfft, FFT, power on bins [0, nfft/2),
    mel, optional floor, log2, DCT; rounded to f32 once.  Shared by K1's
    and K4-float's plain versions."""
    spec = torch.fft.rfft(frames64 * ops.window, dim=-1)[..., : cfg.nfft // 2]
    power = spec.real * spec.real + spec.imag * spec.imag
    melspec = power @ ops.mel
    if mel_floor:
        melspec = torch.clamp_min(melspec, mel_floor)
    return (torch.log2(melspec) @ ops.dct).to(torch.float32)


def mfcc_float_ladder_plain(audio: torch.Tensor,
                            cfg: MFCCConfig = MFCCConfig(),
                            mel_floor: float = 0.0,
                            operators: LadderOperators | None = None
                            ) -> torch.Tensor:
    """K1 as plain torch ops: (..., T) -> (..., F, nceptrums) f32,
    computed in float64 from any input dtype (never truncated to int16)."""
    ops = _resolve(operators, cfg, audio.device)
    emph = framing.preemphasis(audio.to(torch.float64))
    frames = framing.extract_frames(emph, cfg.nfft, cfg.hop)
    return ladder_tail_plain(frames, ops, cfg, mel_floor)


def mfcc_float_ladder(audio: torch.Tensor, cfg: MFCCConfig = MFCCConfig(),
                      mel_floor: float = 0.0,
                      operators: LadderOperators | None = None
                      ) -> torch.Tensor:
    """K1: (..., T) int16 or f32 -> (..., F, nceptrums) f32.  On a CUDA
    tensor this launches the kernel or raises; a CPU tensor takes
    ``mfcc_float_ladder_plain``."""
    global LAUNCHES
    if not fladder_config_ok(cfg):
        raise ValueError(f"config outside K1's family: {cfg}")
    if audio.device.type == "cpu":
        return mfcc_float_ladder_plain(audio, cfg, mel_floor, operators)
    F = framing.num_frames(audio.shape[-1], cfg.hop, cfg.nfft)
    out = launch_tail(FPGA, audio, F, cfg.hop, cfg, operators, what="K1",
                      mel_floor=mel_floor)
    LAUNCHES += 1
    return out


# the ingests of the FP64 tail's walk (csrc/fladder.cu mfcc_tail_walk): K1
# and K6, K1-Kaldi, K7, K7-frames
FPGA, KALDI, F64ISH, F64ISH_FRAMES = range(4)


def launch_tail(ingest: int, x: torch.Tensor, F: int, hop: int,
                cfg: MFCCConfig, ops: LadderOperators | None, *, what: str,
                mel_floor: float = 0.0, wire_grid: bool = False
                ) -> torch.Tensor:
    """Launch the FP64 tail's walk (``mfcc_tail_walk``) with ``ingest`` on
    the rows of (..., T) CUDA input ``x``, F frames a row at ``hop`` (the
    frames ingests: rows of nfft, F = 1); (..., F, nceptrums) f32 out.
    Raises, naming the kernel ``what``, unless ``x`` is a contiguous
    int16 or f32 (frames ingest: f32) CUDA tensor and ``ops`` (None:
    ``default_operators``) pass ``check_operators``.  The one launch of
    K1, K6, K1-Kaldi, K7 and K7-frames; counts only
    MEL_SCHEDULE_LAUNCHES, each caller its own launches."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if ingest == F64ISH_FRAMES:
        dtypes, names = (torch.float32,), "float32"
    else:
        dtypes, names = (torch.int16, torch.float32), "int16 or float32"
    if x.dtype not in dtypes:
        raise TypeError(f"{what} takes {names}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous input")
    ops = _resolve(ops, cfg, x.device)
    check_operators(ops, cfg, x.device, what)
    lead, T = x.shape[:-1], x.shape[-1]
    out = torch.empty(lead + (F, cfg.nceptrums), dtype=torch.float32,
                      device=x.device)
    emph = cfg.preemphasis_coefficient if ingest == KALDI else 0.0
    args = tail_tables(ops, cfg, x.device)
    build.launch(build.library().mfcc_tail_walk, x.device, ingest,
                 int(x.dtype == torch.int16), x.data_ptr(), out.data_ptr(),
                 math.prod(lead), T, F, hop, cfg.nfft, cfg.windowlen, emph,
                 cfg.nfilters, cfg.nceptrums, *args, float(mel_floor),
                 int(wire_grid))
    count_tail(args)
    return out


# -- Kaldi's recipe --------------------------------------------------------------

def mfcc_kaldi_frames_plain(frames: torch.Tensor, cfg: MFCCConfig,
                            operators: LadderOperators | None = None
                            ) -> torch.Tensor:
    """Kaldi's recipe on (..., F, L) frames of raw samples, L >=
    windowlen (positions past windowlen are ignored), as plain torch ops in
    float64: the DC removal and emphasis (``framing.kaldi_preemphasis``),
    the padding to nfft and the tail of ``ladder_tail_plain`` on the
    recipe's tables with the floor FLT_EPSILON; f32 out.  K1-Kaldi's plain
    version and the recipe's chain on any device."""
    ops = _resolve(operators, cfg, frames.device)
    wl = cfg.windowlen
    y = framing.kaldi_preemphasis(frames[..., :wl].to(torch.float64),
                                  cfg.preemphasis_coefficient)
    y = torch.nn.functional.pad(y, (0, cfg.nfft - wl))
    return ladder_tail_plain(y, ops, cfg, tables.FLT_EPSILON)


def mfcc_kaldi_ladder_plain(audio: torch.Tensor, cfg: MFCCConfig,
                            operators: LadderOperators | None = None
                            ) -> torch.Tensor:
    """Kaldi's recipe on (..., T) raw samples -> (..., F, nceptrums) f32,
    F = (T - windowlen) // hop + 1, as plain torch ops in float64."""
    frames = framing.extract_frames(audio, cfg.windowlen, cfg.hop)
    return mfcc_kaldi_frames_plain(frames, cfg, operators)


def mfcc_kaldi_ladder(audio: torch.Tensor, cfg: MFCCConfig,
                      operators: LadderOperators | None = None
                      ) -> torch.Tensor:
    """K1 on Kaldi's recipe: (..., T) int16 or f32 raw samples -> (..., F,
    nceptrums) f32.  On a CUDA tensor one launch of the walk with Kaldi's
    ingest (or the wrapper raises); a CPU tensor takes
    ``mfcc_kaldi_ladder_plain``."""
    global KALDI_LAUNCHES
    if audio.device.type == "cpu":
        return mfcc_kaldi_ladder_plain(audio, cfg, operators)
    if not kaldi_config_ok(cfg):
        raise ValueError(f"config outside K1-Kaldi's family: {cfg}")
    F = framing.num_frames(audio.shape[-1], cfg.hop, cfg.windowlen)
    out = launch_tail(KALDI, audio, F, cfg.hop, cfg, operators,
                      what="K1-Kaldi", mel_floor=tables.FLT_EPSILON)
    KALDI_LAUNCHES += 1
    return out


def mfcc_kaldi_frames(frames: torch.Tensor, cfg: MFCCConfig,
                      operators: LadderOperators | None = None
                      ) -> torch.Tensor:
    """K1 on Kaldi's recipe from (..., F, nfft) int16 or f32 frames of raw
    samples (positions past windowlen ignored) -> (..., F, nceptrums) f32:
    on a CUDA tensor one launch over the frames as rows of one frame each;
    a CPU tensor takes ``mfcc_kaldi_frames_plain``."""
    global KALDI_LAUNCHES
    if frames.device.type == "cpu":
        return mfcc_kaldi_frames_plain(frames, cfg, operators)
    if not kaldi_config_ok(cfg):
        raise ValueError(f"config outside K1-Kaldi's family: {cfg}")
    if frames.shape[-1] != cfg.nfft:
        raise ValueError(f"frames of {frames.shape[-1]} samples; K1-Kaldi "
                         f"takes nfft={cfg.nfft}")
    out = launch_tail(KALDI, frames, 1, cfg.hop, cfg, operators,
                      what="K1-Kaldi frames", mel_floor=tables.FLT_EPSILON)
    KALDI_LAUNCHES += 1
    return out.squeeze(-2)
