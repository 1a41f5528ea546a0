"""Torch models of the warp schedules of the two shared kernel tails.

K2's INT tail (``csrc/int_stages.cuh``: K2, K3, K4-INT, K9, K3-v1, K10) and
K1's float tail (``csrc/fladder_stages.cuh``: K1, K1-Kaldi, K6, K4-float,
K7) give each frame to one warp of 32 lanes and keep its points in
registers; between passes the warp exchanges them through the frame's
shared row.  The batch kernels' warps walk the frames in a persistent grid
(``persistent_walk``; the serving step's writes: ``step_walk``), K2's and
K3-v1's ingest loads each frame from the samples
(``int_audio_ingest_model``), every INT kernel sums the filterbank on the
balanced schedule (``int_fb_balanced``), and every float kernel its mel on
the same kind of schedule in FP64 (``float_mel_balanced``).  This module
states those schedules with the kernels' own index formulas -- which lane
and register holds which point in each pass, which stages run in each
pass, where each point sits in the row, which table entry is each twiddle
-- and runs a batch of frames through them in torch.  The CPU tests use it to check
that every exchange is a permutation, that the passes perform each butterfly
of the standard plan once, and that the scheduled arithmetic equals the
``int_ops`` chain element for element (INT) and the float64 FFT and
``ladder_tail_plain`` (float).  No route runs these models.

Registers are tensors (frames, 32 lanes, points per lane); a row is a tensor
(frames, row length).  The arithmetic per element is the chains' own
(``int_ops._butterfly``, ``int_ops.log2fix_int``; float64 complex).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables
from ..config import FILTERBANK_WIDTH, MFCCConfig
from . import fladder, int_ops
from .fladder import LadderOperators
from .int_fused import FB_STEPS, LANES, int_operators

_L = torch.arange(LANES)


# -- INT: the 512-point ladder and the DCT ladder (int_stages.cuh) ------------

INT_NFFT = 512
INT_PTS = INT_NFFT // LANES            # ladder points per lane
INT_ROW = INT_NFFT + INT_NFFT // 16    # padded row
INT_FB_TABLE = 1536                    # the lane-per-filter weight table

# (layout, stages) of the ladder's three passes
INT_PASSES = (("A", (0, 1, 2, 3)), ("B", (4, 5, 6, 7)), ("C", (8,)))


def int_pad(i):
    """pad(i) = i + i/16: a point's word in its frame's row."""
    return i + (i >> 4)


def int_layout(name: str) -> torch.Tensor:
    """(32, 16) int64: the point lane l's register r holds in layout A
    (16l + r), B (256(l >> 4) + (l & 15) + 16r) or C (l + 32r)."""
    lane, r = _L[:, None], torch.arange(INT_PTS)[None, :]
    return {"A": 16 * lane + r,
            "B": ((lane >> 4) << 8) + (lane & 15) + 16 * r,
            "C": lane + 32 * r}[name]


def int_stage_entry(s: int, j) -> tuple:
    """(entry of the kernel's stage table stw, index into the 256 twiddles
    it holds) of stage s's twiddle j: (2^s - 1) + j, j << (8 - s)."""
    return (1 << s) - 1 + j, j << (8 - s)


def int_butterflies(name: str, s: int) -> tuple:
    """The kernel's butterflies of ladder stage s in layout ``name``: int64
    tensors (lane, r0, r1, twiddle index into the 256 twiddles), one entry
    per butterfly; stage 8 runs only its 8 lower registers' pairs."""
    lanes, r0s, tws = [], [], []
    for r in range(INT_PTS):
        if name == "A":
            if r & (1 << s):
                continue
            span, j = 1 << s, torch.full((LANES,), r & ((1 << s) - 1))
        elif name == "B":
            q = s - 4
            if r & (1 << q):
                continue
            span, j = 1 << q, (_L & 15) + 16 * (r & ((1 << q) - 1))
        else:
            if r >= INT_PTS // 2:
                continue
            span, j = INT_PTS // 2, _L + 32 * r
        lanes.append(_L)
        r0s.append(torch.full((LANES,), r))
        tws.append(int_stage_entry(s, j)[1])
    lane, r0 = torch.cat(lanes), torch.cat(r0s)
    return lane, r0, r0 + span, torch.cat(tws)


def int_ladder_plan() -> list:
    """The ladder's butterflies by stage as (i0, i1, twiddle) point triples,
    from the kernel's layouts: comparable with tables.dit_stage_plan(512)."""
    plan = []
    for name, stages in INT_PASSES:
        pos = int_layout(name)
        for s in stages:
            lane, r0, r1, tw = int_butterflies(name, s)
            plan.append((pos[lane, r0], pos[lane, r1], tw))
    return plan


def _pack(re, im):
    return (re & 0xFFFF) | (im << 16)


def _unpack(v):
    return int_ops.wrap_signed(v, 16), v >> 16


def _gather_regs(row, pos):
    """(N, 32, R) words of the row at the padded positions pos (32, R)."""
    return row[:, int_pad(pos).reshape(-1)].reshape(row.shape[0], *pos.shape)


def _scatter_regs(row, pos, v):
    row[:, int_pad(pos).reshape(-1)] = v.reshape(row.shape[0], -1)


def _ladder_pass(re, im, name, stages, tw):
    for s in stages:
        lane, r0, r1, ti = int_butterflies(name, s)
        y = int_ops._butterfly(re[:, lane, r0], im[:, lane, r0],
                               re[:, lane, r1], im[:, lane, r1],
                               tw[ti, 0], tw[ti, 1], 16)
        re, im = re.clone(), im.clone()
        re[:, lane, r0], im[:, lane, r0] = y[0], y[1]
        re[:, lane, r1], im[:, lane, r1] = y[2], y[3]
    return re, im


def int_first_sample() -> torch.Tensor:
    """(32, 16) int64: the sample lane l's register r holds in the ladder's
    first layout, ``first_sample(r)`` = bitrev(16l + r, 9)."""
    return _bitrev(int_layout("A"), int(np.log2(INT_NFFT)))


def int_first_layout(windowed: torch.Tensor) -> torch.Tensor:
    """(N, 512) int32 windowed frames as the warps hold them after their
    load: (N, 32, 16), lane l's register r sample ``first_sample(r)``."""
    return windowed.to(torch.int32)[:, int_first_sample()]


def int_audio_ingest_model(x: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                           ) -> torch.Tensor:
    """K2's and K3-v1's ingest (``int_stages.cuh`` ``load_audio_frame``) on
    (S, T) int16 or int32 samples, with the kernel's index formulas: warp
    G = s*F + g, lane l, register r takes sample p = first_sample(r) of
    frame g, x[s, g*hop + p], and prev = x[s, g*hop + p - 1], or 0 at t =
    0; int16 samples take ``preemph``, int32 ``preemph32`` (x + (prev >> 5)
    - prev in uint32, then wrap16), then the window wrap16((v * curve[p]
    mod 2^32) >> 9).  Returns (S*F, 32, 16) int32 registers."""
    S, T = x.shape
    F = (T - INT_NFFT) // cfg.hop + 1
    curve = torch.as_tensor(tables.int_window_curve(INT_NFFT,
                                                    cfg.window_precision),
                            dtype=torch.int64)
    p = int_first_sample()                                   # (32, 16)
    g = torch.arange(F)[:, None, None]
    t = g * cfg.hop + p                                      # (F, 32, 16)
    xs = x.to(torch.int64)
    cur = xs[:, t]                                           # (S, F, 32, 16)
    first = (t == 0)
    prev = torch.where(first, torch.zeros((), dtype=torch.int64),
                       xs[:, torch.clamp(t - 1, min=0)])
    if x.dtype == torch.int16:
        emph = int_ops.wrap_signed(cur + (prev >> 5) - prev, 16)
    elif x.dtype == torch.int32:
        y = ((cur & 0xFFFFFFFF) + ((prev >> 5) & 0xFFFFFFFF)
             - (prev & 0xFFFFFFFF)) & 0xFFFFFFFF             # uint32
        emph = int_ops.wrap_signed(y, 16)
    else:
        raise TypeError(f"the ingest reads int16 or int32, got {x.dtype}")
    prod = (emph * curve[p]) & 0xFFFFFFFF                    # uint32 product
    prod = prod - ((prod >> 31) << 32)                       # as int32
    win = int_ops.wrap_signed(prod >> (cfg.window_precision + 1), 16)
    return win.reshape(S * F, LANES, INT_PTS).to(torch.int32)


def int_ladder_power_model(windowed: torch.Tensor) -> torch.Tensor:
    """The warp's ladder and power on (N, 512) int32 windowed frames: the
    bit-reversed load (``int_first_layout``), then
    ``int_ladder_power_registers``.  Returns (N, 256) int32 power."""
    return int_ladder_power_registers(int_first_layout(windowed))


def int_ladder_power_registers(re: torch.Tensor) -> torch.Tensor:
    """The warp's ladder and power from its registers in the first layout
    (N, 32, 16) int32, as the kernels' warps load them: layout A's four
    stages, the packed exchange to B, four stages, the exchange to C,
    stage 8's lower outputs and their power.  Returns (N, 256) int32
    power, bin l + 32k from lane l's register k."""
    N = re.shape[0]
    tw = torch.as_tensor(np.stack(tables.twiddle_table(INT_NFFT, 16), axis=1),
                         dtype=torch.int32)
    row = torch.zeros((N, INT_ROW), dtype=torch.int32)
    re = re.to(torch.int32)
    im = torch.zeros_like(re)
    for (name, stages), nxt in zip(INT_PASSES, ("B", "C", None)):
        re, im = _ladder_pass(re, im, name, stages, tw)
        if nxt is not None:
            _scatter_regs(row, int_layout(name), _pack(re, im))
            re, im = _unpack(_gather_regs(row, int_layout(nxt)))
    half = INT_PTS // 2
    pw = int_ops.power_int(re[:, :, :half], im[:, :, :half], 16, 30)
    out = torch.empty((N, INT_NFFT // 2), dtype=torch.int32)
    out[:, int_layout("C")[:, :half].reshape(-1)] = pw.reshape(N, -1)
    return out


def int_fb_table(W: torch.Tensor, band: torch.Tensor) -> torch.Tensor:
    """The lane-per-filter schedule's banded filterbank table fbt[t * nf +
    j] = W[lo_j + t, j] (0 past the band), INT_FB_TABLE entries."""
    nf = W.shape[1]
    e = torch.arange(INT_FB_TABLE)
    t, j = e // nf, e % nf
    lo, hi = band[j, 0], band[j, 1]
    inside = lo + t < hi
    return torch.where(inside, W[torch.clamp(lo + t, max=W.shape[0] - 1), j],
                       torch.zeros((), dtype=torch.int64))


def int_dct_plan(nf: int) -> tuple:
    """The DCT ladder's butterflies the kernel runs, by stage, as (i0, i1,
    twiddle) triples over the 4*nf points, and those it skips: the lower
    half's (both inputs 0 through every stage but the last) and the last
    stage's beyond lane 31 (outputs no lane keeps)."""
    h = 2 * nf
    log2h = int(np.log2(h))
    ran, skipped = [], []
    u = _L[:, None] + 32 * torch.arange(h // LANES)[None, :]      # (32, R)
    for s in range(log2h + 1):
        span = 1 << s
        if s < log2h:                  # upper half: pairs inside it
            lo = u[(u & span) == 0]
            j = lo & (span - 1)
            ran.append((h + lo, h + lo + span, j << (log2h - s)))
            t = torch.arange(h // 2)
            g, jj = t >> s, t & (span - 1)
            i0 = (g << (s + 1)) + jj
            skipped.append((i0, i0 + span, jj << (log2h - s)))
        else:                          # last stage: lane k pairs k, h + k
            k = _L
            ran.append((k, h + k, k))
            rest = torch.arange(LANES, h)
            skipped.append((rest, h + rest, rest))
    return ran, skipped


def _shfl_butterfly(vr, vi, span, twr, twi, real):
    """One DCT stage whose pairs lie in lanes l and l ^ span (same register):
    each lane keeps its own output."""
    idx = _L ^ span
    pr, pi = vr[:, idx], (torch.zeros_like(vi) if real else vi[:, idx])
    upper = ((_L & span) != 0)[None, :]
    x0r, x0i = torch.where(upper, pr, vr), torch.where(upper, pi, vi)
    x1r, x1i = torch.where(upper, vr, pr), torch.where(upper, vi, pi)
    y0r, y0i, y1r, y1i = int_ops._butterfly(x0r, x0i, x1r, x1i, twr, twi, 16)
    return torch.where(upper, y1r, y0r), torch.where(upper, y1i, y0i)


def int_fb_balanced(power: torch.Tensor, fbs: torch.Tensor) -> torch.Tensor:
    """The balanced filterbank (``int_stages.cuh`` ``post_power_balanced``)
    on (N, 256) int32 power rows, reading the schedule ``fbs``
    (``int_fused.fb_schedule``) with the kernel's index formulas: for step
    i, lane l reads entry i*32 + l {weight, offsets}, the power word at
    byte offsets & 0xFFFF of its row, adds the product to its running sum
    mod 2^64 and, where offsets >> 16 is not 0, stores the sum to the
    uint64 slot at that byte; then lane j with gather word g starts from
    minus the slot before byte g & 0xFFFF if bit 31 is set, else 0, and
    adds the (g >> 16) & 0x7FFF slots from there on.  Returns (N, 32)
    int64: lane j's sum, filter j's for j < nfilters."""
    N = power.shape[0]
    words = fbs.long() & 0xFFFFFFFF
    ent = words[: FB_STEPS * LANES * 2].reshape(FB_STEPS, LANES, 2)
    gather = words[FB_STEPS * LANES * 2:]
    row = torch.zeros((N, INT_ROW), dtype=torch.int64)      # 32-bit words
    row[:, : INT_NFFT // 2] = power.long()
    slots = torch.zeros((N, INT_ROW // 2), dtype=torch.int64)  # 64-bit
    acc = torch.zeros((N, LANES), dtype=torch.int64)
    for i in range(FB_STEPS):
        w, offs = ent[i, :, 0], ent[i, :, 1]
        acc = acc + row[:, (offs & 0xFFFF) >> 2] * w         # mod 2^64
        slot = offs >> 16
        store = slot != 0
        slots[:, slot[store] >> 3] = acc[:, store]
    first, count = (gather & 0xFFFF) >> 3, (gather >> 16) & 0x7FFF
    sub = (gather >> 31) != 0
    out = torch.where(sub, -slots[:, torch.clamp(first - 1, min=0)],
                      torch.zeros((), dtype=torch.int64))
    for k in range(int(count.max())):
        live = k < count
        out[:, live] = out[:, live] + slots[:, (first + k)[live]]
    return out


def int_post_power_model(power: torch.Tensor, cfg: MFCCConfig,
                         balanced: bool = False) -> torch.Tensor:
    """The warp's post-power stages on (N, 256) int32 power: the filterbank
    a lane per filter (two lanes per filter at 16 filters, their sums
    joined: no kernel runs it, it is the schedule the balanced one is held
    to), or with ``balanced`` on the balanced schedule
    (``int_fb_balanced``; every INT kernel's), log2, the DCT
    ladder's upper half in lanes and shuffles, and lane c's last-stage
    output c.  Returns (N, ncep) int32."""
    ops = int_operators(cfg, torch.device("cpu"))
    nf, ncep = cfg.nfilters, min(cfg.nceptrums, cfg.nfilters)
    N = power.shape[0]
    if balanced:
        lpf = 1
        acc = int_fb_balanced(power, ops.fbs)
    else:
        lpf = LANES // nf
        j, h0 = _L // lpf, _L % lpf
        band = ops.band.long()
        lo, w = band[j, 0], band[j, 1] - band[j, 0]
        cap = INT_FB_TABLE // nf
        fbt = int_fb_table(ops.fbw, band)
        t = h0[:, None] + lpf * torch.arange(int(w.max()) // lpf + 1)[None, :]
        live = t < w[:, None]
        k = torch.clamp(lo[:, None] + t, max=INT_NFFT // 2 - 1)
        wt = torch.where(t < cap, fbt[torch.clamp(t * nf + j[:, None],
                                                  max=INT_FB_TABLE - 1)],
                         ops.fbw[k, j[:, None]])
        wt = torch.where(live, wt, torch.zeros((), dtype=torch.int64))
        acc = (power.long()[:, k] * wt).sum(-1)            # mod 2^64, per lane
        if lpf == 2:
            acc = acc + acc[:, _L ^ 1]
    mel = ((acc >> ops.fb_shift) & 0xFFFF).to(torch.int32)
    logmel = int_ops.log2fix_int(mel, FILTERBANK_WIDTH, cfg.log_width_output)

    dtw = ops.dtw.long()
    hh = 2 * nf
    log2h = int(np.log2(hh))
    nr = hh // LANES
    u = _L[:, None] + 32 * torch.arange(nr)[None, :]
    src = torch.as_tensor([[int(f"{int(v):0{log2h + 1}b}"[::-1], 2)
                            for v in row] for row in (hh + u)])
    kk = torch.where(src < hh, (src - 1) >> 1, (2 * hh - 1 - src) >> 1)
    vr = logmel[:, (kk * lpf).reshape(-1)].reshape(N, LANES, nr).long()
    vi = torch.zeros_like(vr)
    for s in range(5):
        ti = (_L & ((1 << s) - 1)) << (log2h - s)
        for r in range(nr):
            vr[:, :, r], vi[:, :, r] = _shfl_butterfly(
                vr[:, :, r], vi[:, :, r], 1 << s, dtw[ti, 0], dtw[ti, 1],
                s == 0)
    if nr == 2:                        # span 32: the lane's own two points
        ti = _L << 1
        y = int_ops._butterfly(vr[:, :, 0], vi[:, :, 0], vr[:, :, 1],
                               vi[:, :, 1], dtw[ti, 0], dtw[ti, 1], 16)
        vr = torch.stack([y[0], y[2]], -1)
        vi = torch.stack([y[1], y[3]], -1)
    zero = torch.zeros_like(vr[:, :, 0])
    y0r = int_ops._butterfly(zero, zero, vr[:, :, 0], vi[:, :, 0],
                             dtw[_L, 0], dtw[_L, 1], 16)[0]
    return y0r[:, :ncep].to(torch.int32)


def int_tail_model(frames: torch.Tensor, cfg: MFCCConfig = MFCCConfig(),
                   balanced: bool = False) -> torch.Tensor:
    """K3's function through the warp schedule: (N, 512) int32
    pre-emphasized frames -> (N, ncep) int32; ``balanced`` (the kernels'
    filterbank) as ``int_post_power_model`` takes it."""
    win = int_ops.window_int(frames, cfg.nfft, cfg.window_precision,
                             cfg.width)
    return int_post_power_model(int_ladder_power_model(win), cfg, balanced)


# -- the persistent walk (persistent.cuh; K1, K7, K2, K3-v1, K3) --------------

FRAMES_PER_BLOCK = 8    # kFrames: 8 warps a block, one frame a warp


def persistent_grid(tiles: int, sms: int, per_sm: int) -> int:
    """``persistent_grid`` of persistent.cuh: as many blocks as the card
    holds at once (``per_sm`` from the occupancy calculator, 1 where it
    gives 0), no more than ``tiles`` (8-frame tiles of work)."""
    resident = sms * (per_sm if per_sm > 0 else 1)
    return tiles if tiles < resident else resident


def persistent_walk(frames: int, F: int, grid: int) -> list:
    """The frames each warp of a persistent launch of ``grid`` blocks
    takes, by the kernels' loop bounds: warp w of block b starts at G =
    b*8 + w and steps by grid*8 while G < frames; flat frame G is stream s
    = G // F, frame g = G - s*F, and ``first`` (the signal's start: the
    sample before the frame reads as 0) is g == 0.  The frames entries walk
    rows the same way (F = frames).  Returns [(b, w, G, s, g, first)],
    each warp's frames in the order it takes them."""
    out = []
    for b in range(grid):
        for w in range(FRAMES_PER_BLOCK):
            G = b * FRAMES_PER_BLOCK + w
            while G < frames:
                s = G // F
                g = G - s * F
                out.append((b, w, G, s, g, g == 0))
                G += grid * FRAMES_PER_BLOCK
    return out


def epilogue_walk(M: int, grid: int) -> list:
    """K10's epilogue's loop (``int_split2.cu`` ``int_epi_kernel``) over
    M power rows in ``grid`` blocks: warp w of block b starts at m = b*8 +
    w, loads row m into registers if m < M, then while m < M stores the
    loaded row to its shared row, loads row m + step (step = grid*8) if
    that is < M, runs the stored row and steps m.  Returns [(b, w, row)],
    the rows each warp runs in order; ``persistent_walk`` with F = M gives
    the same rows when the prefetch runs the row the loop stands on."""
    out, step = [], grid * FRAMES_PER_BLOCK
    for b in range(grid):
        for w in range(FRAMES_PER_BLOCK):
            m = b * FRAMES_PER_BLOCK + w
            loaded = m if m < M else None
            while m < M:
                row = loaded
                if m + step < M:
                    loaded = m + step
                out.append((b, w, row))
                m += step
    return out


def _tiles(M: int, F: int):
    """Each tile of K4's staged walk (``stream_step.cu`` ``Tile``): (t, G0,
    G1, s0, ns) for slots [G0, G1) over streams s0 .. s0 + ns - 1."""
    for t in range(-(-M // FRAMES_PER_BLOCK)):
        G0 = t * FRAMES_PER_BLOCK
        G1 = min(G0 + FRAMES_PER_BLOCK, M)
        yield t, G0, G1, G0 // F, (G1 - 1) // F - G0 // F + 1


def step_walk(S: int, F: int, grid: int, P: int = INT_NFFT - 1, *,
              staged: bool = True) -> dict:
    """The writes of the serving step K4's persistent kernels
    (``stream_step.cu``) over S streams of F frame slots in ``grid``
    blocks, by the kernels' loop bounds and index formulas.  Both paths:
    block b walks tiles t = b, b + grid, ... of 8 slots and warp w takes
    slot G = t*8 + w while G < S*F (the per-point kernels' G = b*8 + w
    stepping by grid*8 is the same walk); slot G is stream s = G // F,
    slot g = G - s*F, and its warp writes the features of row G and (lane
    0) mask entry G.  The staged window (``staged``: the main path): the
    block whose tile holds stream s's slot 0 writes all P carry positions
    of s, position p by its thread p mod 256, and its thread s - s0 (s0
    the tile's first stream) the new count and prev.  The per-point
    kernels: the warp on slot g writes carry positions [g * share, min((g
    + 1) * share, P)) of stream s (share = ceil(P / F)), its lanes striding
    by 32, and on slot 0 lane 0 the new count and prev.  Returns int64
    arrays of the flat indices written, in the order the warps or blocks
    take them: ``"feats"`` and ``"mask"`` G, ``"carry"`` s*P + position,
    ``"count"`` and ``"prev"`` s; ``"warp"``, the (block, warp) of each
    slot in ``"feats"``; ``"carry_by"`` and ``"state_by"``, the (block,
    thread) that writes each entry of ``"carry"`` and of ``"count"``."""
    step = grid * FRAMES_PER_BLOCK
    M = S * F
    firsts = np.arange(min(step, M))
    G = np.concatenate([np.arange(f, M, step) for f in firsts]
                       or [np.zeros(0, np.int64)]).astype(np.int64)
    warp = np.concatenate([np.full(len(range(f, M, step)), f)
                           for f in firsts] or [np.zeros(0, np.int64)])
    block = warp // FRAMES_PER_BLOCK
    s, g = G // F, G % F
    first = g == 0
    if staged:
        threads = FRAMES_PER_BLOCK * LANES
        carry, carry_by, count, state_by = [], [], [], []
        for t, G0, G1, s0, ns in _tiles(M, F):
            for i in range(ns):
                if (s0 + i) * F < G0:
                    continue               # slot 0 is in an earlier tile
                carry.append((s0 + i) * P + np.arange(P))
                carry_by.append(np.stack([np.full(P, t % grid),
                                          np.arange(P) % threads], axis=1))
                count.append(s0 + i)
                state_by.append((t % grid, i))
        none = np.zeros((0, 2), np.int64)
        return {"feats": G, "mask": G,
                "carry": np.concatenate(carry or [np.zeros(0, np.int64)]),
                "count": np.array(count, np.int64),
                "prev": np.array(count, np.int64),
                "warp": np.stack([block, warp % FRAMES_PER_BLOCK], axis=1),
                "carry_by": np.concatenate(carry_by or [none]),
                "state_by": np.array(state_by, np.int64).reshape(-1, 2)}
    share = -(-P // F)
    lo = np.minimum(g * share, P)
    n = np.minimum((g + 1) * share, P) - lo
    starts = np.repeat(s * P + lo - np.cumsum(n) + n, n)
    carry = starts + np.arange(int(n.sum()))
    # the lane of each carry position: its offset in the warp's share mod 32
    lane = (np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)) % LANES
    wslot = np.repeat(warp % FRAMES_PER_BLOCK, n)
    return {"feats": G, "mask": G, "carry": carry, "count": s[first],
            "prev": s[first],
            "warp": np.stack([block, warp % FRAMES_PER_BLOCK], axis=1),
            "carry_by": np.stack([np.repeat(block, n),
                                  wslot * LANES + lane], axis=1),
            "state_by": np.stack([block[first],
                                  (warp % FRAMES_PER_BLOCK)[first] * LANES],
                                 axis=1)}


def step_rows(S: int, F: int, C: int, in_bytes: int, base: int) -> list:
    """How the staged kernels copy the rows of each tile's streams into a
    row buffer (``stream_step.cu`` ``run_issue``, ``rows_of``), for the
    chunk rows of an (S, C) chunk of ``in_bytes`` samples, rows back to
    back, whose first sample is at byte address ``base`` (the carry rows
    are copied the same way): [(s0, ns, xa, n, m)] a tile, its streams s0
    .. s0 + ns - 1, the aligned 16-byte blocks [xa, xa + 16*n) copied (from
    the block holding the first stream's first sample through the one
    holding the last stream's last) and the byte m at which sample 0 of
    stream s0 sits in the copy (stream s0 + i's sample t at m + (i*C + t) *
    in_bytes)."""
    out = []
    for t, G0, G1, s0, ns in _tiles(S * F, F):
        xb = base + s0 * C * in_bytes
        xa = xb & ~15
        out.append((s0, ns, xa, (xb - xa + in_bytes * C * ns + 15) // 16,
                    xb & 15))
    return out


def step_e(carry_row, x_row, prev, q: int, P: int, C: int, emph):
    """E[q] of a stream from its rows (``stream_step.cu`` ``e_at``, and
    ``e_in`` inside [0, P + C)): the carry row below P, the chunk sample
    and the one before (prev at the chunk's start) through ``emph`` in [P,
    P + C), 0 elsewhere."""
    if 0 <= q < P:
        return carry_row[q]
    if P <= q < P + C:
        return emph(x_row[q - P], x_row[q - P - 1] if q > P else prev)
    return 0


# -- float: the packed FFT, unpack, mel and DCT (fladder_stages.cuh) ----------

def swz(i):
    """The row swizzle: bits 3..8 of i select XOR masks 2, 5, 6, 4, 1, 2 of
    bits 0-2 (fladder_stages.cuh ``swz``)."""
    out = 0
    for bit, mask in zip(range(3, 9), (2, 5, 6, 4, 1, 2)):
        out = out ^ (((i >> bit) & 1) * mask)
    return out


def slot(i):
    """Where point i of a frame sits in its row: i ^ swz(i)."""
    return i ^ swz(i)


def float_passes(log2p: int) -> list:
    """[(b, hi)]: pass p runs stages [b, hi) on the layout with register
    bits [b, b + log2p), hi = 5 + log2p - log2p*p."""
    out, p = [], 0
    while True:
        hi = 5 + log2p - log2p * p
        b = hi - log2p if hi > log2p else 0
        out.append((b, hi))
        if b == 0:
            return out
        p += 1


def float_layout(log2p: int, b: int) -> torch.Tensor:
    """(32, P) int64: lane l's register r holds point (l mod 2^b) | r << b |
    (l >> b) << (b + log2p)."""
    lane, r = _L[:, None], torch.arange(1 << log2p)[None, :]
    return (lane & ((1 << b) - 1)) | (r << b) | ((lane >> b) << (b + log2p))


def float_butterflies(log2p: int, b: int, t: int) -> tuple:
    """The kernel's DIF butterflies of stage t (span 2^t) in the layout of
    base b: int64 (lane, r0, r1, j), the twiddle W_(2^(t+1))^j at stage
    table entry (2^t - 1) + j (j = 0 at t = 0, where none is applied)."""
    q = t - b
    lanes, r0s, js = [], [], []
    for r in range(1 << log2p):
        if r & (1 << q):
            continue
        lanes.append(_L)
        r0s.append(torch.full((LANES,), r))
        js.append((_L & ((1 << b) - 1)) | ((r & ((1 << q) - 1)) << b))
    r0 = torch.cat(r0s)
    return torch.cat(lanes), r0, r0 + (1 << q), torch.cat(js)


def float_fft_plan(log2p: int) -> list:
    """The passes' butterflies as (stage t, i0, i1, j) over points, from
    the kernel's layouts: comparable with the radix-2 DIF plan."""
    plan = []
    for b, hi in float_passes(log2p):
        pos = float_layout(log2p, b)
        for t in range(hi - 1, b - 1, -1):
            lane, r0, r1, j = float_butterflies(log2p, b, t)
            plan.append((t, pos[lane, r0], pos[lane, r1], j))
    return plan


def _bitrev(v, bits):
    return torch.as_tensor([int(f"{int(x):0{bits}b}"[::-1], 2)
                            for x in v.reshape(-1)]).reshape(v.shape)


def float_spectrum_model(z: torch.Tensor, nfft: int) -> torch.Tensor:
    """The warp's FFT and unpack on (N, M) complex128 packed frames z[m] =
    y[2m] + i*y[2m+1] (M = nfft/2): the passes in registers with exchanges
    through the swizzled row, then lane l's bins k = l + 32u and M - k (M/2
    for k = 0) from Z[k] and Z[M - k].  Returns X, (N, M) complex128."""
    N, M = z.shape
    log2p = int(np.log2(M // LANES))
    log2m = 5 + log2p
    ang = 2.0 * np.pi * np.arange(M) / nfft
    W = torch.as_tensor(np.cos(ang) - 1j * np.sin(ang))    # W_nfft^k
    row = torch.empty((N, M), dtype=torch.complex128)
    row[:, slot(torch.arange(M))] = z
    prev = None
    for b, hi in float_passes(log2p):
        pos = float_layout(log2p, b)
        if prev is not None:
            row[:, slot(prev).reshape(-1)] = x.reshape(N, -1)
        x = row[:, slot(pos).reshape(-1)].reshape(N, LANES, -1).clone()
        for t in range(hi - 1, b - 1, -1):
            lane, r0, r1, j = float_butterflies(log2p, b, t)
            a, c = x[:, lane, r0], x[:, lane, r1]
            d = a - c
            x[:, lane, r0] = a + c
            x[:, lane, r1] = d if t == 0 else d * W[j << (log2m - t)]
        prev = pos
    row[:, slot(prev).reshape(-1)] = x.reshape(N, -1)
    k = _L[:, None] + 32 * torch.arange(M // 64)[None, :]
    k2 = torch.where(k > 0, M - k, M // 2)
    zk = row[:, slot(_bitrev(k, log2m)).reshape(-1)].reshape(N, *k.shape)
    z2 = row[:, slot(_bitrev(k2, log2m)).reshape(-1)].reshape(N, *k.shape)
    nz = (k > 0)[None]

    def unpack(a, bconj, w):
        xe = 0.5 * (a + bconj.conj())
        xo = (a - bconj.conj()) / 2j
        return xe + w * xo

    X = torch.empty((N, M), dtype=torch.complex128)
    X[:, k.reshape(-1)] = unpack(zk, torch.where(nz, z2, zk),
                                 W[k]).reshape(N, -1)
    X[:, k2.reshape(-1)] = unpack(z2, torch.where(nz, zk, z2),
                                  W[k2]).reshape(N, -1)
    return X


def float_mel_lanes(power: torch.Tensor, ops: LadderOperators
                    ) -> torch.Tensor:
    """The mel a lane per filter over its band (band offsets, ascending
    bins), the tail's loop without a schedule, on (N, M) float64 power.
    Returns (N, nfilters) float64."""
    nf = ops.mel.shape[1]
    lo, hi = ops.band[:, 0].long(), ops.band[:, 1].long()
    acc = torch.zeros((power.shape[0], nf), dtype=torch.float64)
    for t in range(int((hi - lo).max())):
        live = lo + t < hi
        kk = torch.clamp(lo + t, max=power.shape[1] - 1)
        term = power[:, kk] * ops.mel[kk, torch.arange(nf)]
        acc = torch.where(live, acc + term, acc)
    return acc


def float_mel_balanced(power: torch.Tensor, words: np.ndarray,
                       nfilters: int) -> torch.Tensor:
    """The mel on the balanced schedule (``fladder_stages.cuh``
    ``mel_log2``) on (N, M) float64 power rows, reading the int32 words
    of ``fladder.mel_schedule`` with the kernel's index formulas: for step
    i, lane l reads entry i*32 + l {weight, power byte offset, slot byte
    offset}, adds power * weight to its sum and, where the slot offset is
    not 0, stores the sum to that double of its row and restarts it from 0;
    then lane j adds the (g >> 16) slots from byte g & 0xFFFF on, g its
    gather word.  Returns (N, nfilters) float64."""
    N, M = power.shape
    steps = (len(words) - nfilters) // (fladder.MEL_LANES
                                        * fladder.MEL_ENTRY_WORDS)
    ent = words[: steps * LANES * 4].view(
        [("w", "<f8"), ("k", "<i4"), ("s", "<i4")]).reshape(steps, LANES)
    gather = words[steps * LANES * 4:].astype(np.int64)
    row = torch.zeros((N, 2 * M), dtype=torch.float64)
    row[:, :M] = power
    acc = torch.zeros((N, LANES), dtype=torch.float64)
    for i in range(steps):
        w = torch.from_numpy(ent["w"][i].copy())
        k = torch.from_numpy(ent["k"][i] // 8).long()
        at = torch.from_numpy(ent["s"][i] // 8).long()
        acc = acc + row[:, k] * w
        store = at != 0
        row[:, at[store]] = acc[:, store]
        acc = torch.where(store, torch.zeros((), dtype=torch.float64), acc)
    out = torch.zeros((N, nfilters), dtype=torch.float64)
    for j, g in enumerate(gather.tolist()):
        for q in range(g >> 16):
            out[:, j] = out[:, j] + row[:, (g & 0xFFFF) // 8 + q]
    return out


def float_dct_model(lm: torch.Tensor, dct: torch.Tensor) -> torch.Tensor:
    """The tail's DCT (``fladder_stages.cuh`` ``dct_out``) on (N, nfilters)
    float64 log-mel rows: a lane a cepstrum over every filter in rounds of
    32, and past the last full round of an ncep > 32 the r left on groups of
    r lanes, each a share of the filters in order, joined as the shuffles
    join them.  Returns (N, ncep) f32."""
    nf, ncep = dct.shape
    full = ncep & -LANES if ncep > LANES else ncep
    out = torch.empty((lm.shape[0], ncep), dtype=torch.float64)
    out[:, :full] = lm @ dct[:, :full]
    r = ncep - full
    if r:
        groups = 1
        while 2 * groups * r <= LANES:
            groups *= 2
        share = -(-nf // groups)
        part = [lm[:, g * share:(g + 1) * share]
                @ dct[g * share:(g + 1) * share, full:] for g in range(groups)]
        h = groups // 2
        while h:                      # group g adds group g + h
            part = [part[g] + part[g + h] for g in range(h)]
            h //= 2
        out[:, full:] = part[0]
    return out.to(torch.float32)


def float_tail_model(frames64: torch.Tensor, ops: LadderOperators,
                     cfg: MFCCConfig, mel_floor: float = 0.0,
                     balanced: bool = True) -> torch.Tensor:
    """K1's tail through the warp schedule on (N, nfft) float64
    pre-emphasized frames: window * 1/nfft, packing, the spectrum model,
    |X|^2, the mel on the balanced schedule where ``ops.mel`` has one
    (``float_mel_balanced``), else, or without ``balanced``, a lane per
    filter (``float_mel_lanes``), as the kernels choose; floor, log2, the
    DCT (``float_dct_model``).  (N, ncep) f32."""
    y = frames64 * ops.window
    z = torch.complex(y[:, 0::2], y[:, 1::2])
    X = float_spectrum_model(z, cfg.nfft)
    power = X.real * X.real + X.imag * X.imag
    nf = ops.mel.shape[1]
    words = fladder.mel_schedule(ops.mel.numpy()) if balanced else None
    if words is not None:
        acc = float_mel_balanced(power, words, nf)
    else:
        acc = float_mel_lanes(power, ops)
    if mel_floor:
        acc = torch.clamp_min(acc, mel_floor)
    return float_dct_model(torch.log2(acc), ops.dct)
