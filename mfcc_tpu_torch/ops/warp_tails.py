"""Torch models of the warp schedules of the two shared kernel tails.

K2's INT tail (``csrc/int_stages.cuh``: K2, K3, K4-INT, K9, K3-v1, K10) and
K1's float tail (``csrc/fladder_stages.cuh``: K1, K6, K4-float, K7) give
each frame to one warp of 32 lanes and keep its points in registers; between
passes the warp exchanges them through the frame's shared row.  This module
states those schedules with the kernels' own index formulas -- which lane
and register holds which point in each pass, which stages run in each pass,
where each point sits in the row, which table entry is each twiddle -- and
runs a batch of frames through them in torch.  The CPU tests use it to check
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
from . import int_ops
from .fladder import LadderOperators
from .int_fused import int_operators

LANES = 32
_L = torch.arange(LANES)


# -- INT: the 512-point ladder and the DCT ladder (int_stages.cuh) -------------

INT_NFFT = 512
INT_PTS = INT_NFFT // LANES            # ladder points per lane
INT_ROW = INT_NFFT + INT_NFFT // 16    # padded row
INT_FB_TABLE = 1536                    # kFbTable

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


def int_ladder_power_model(windowed: torch.Tensor) -> torch.Tensor:
    """The warp's ladder and power on (N, 512) int32 windowed frames: the
    bit-reversed load (the kernels' warps load these values straight into
    layout A), layout A's four stages, the packed exchange to B, four
    stages, the exchange to C, stage 8's lower outputs and their power.
    Returns (N, 256) int32 power, bin l + 32k from lane l's register k."""
    N = windowed.shape[0]
    tw = torch.as_tensor(np.stack(tables.twiddle_table(INT_NFFT, 16), axis=1),
                         dtype=torch.int32)
    row = torch.zeros((N, INT_ROW), dtype=torch.int32)
    p = torch.arange(INT_NFFT)
    bits = int(np.log2(INT_NFFT))
    rev = torch.as_tensor([int(f"{v:0{bits}b}"[::-1], 2) for v in range(INT_NFFT)])
    row[:, int_pad(rev[p])] = windowed.to(torch.int32)
    re = _gather_regs(row, int_layout("A"))
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
    """The block's banded filterbank table fbt[t * nf + j] = W[lo_j + t, j]
    (0 past the band), kFbTable entries."""
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


def int_post_power_model(power: torch.Tensor, cfg: MFCCConfig) -> torch.Tensor:
    """The warp's post-power stages on (N, 256) int32 power: the filterbank
    a lane per filter (two lanes per filter at 16 filters, their sums
    joined), log2, the DCT ladder's upper half in lanes and shuffles, and
    lane c's last-stage output c.  Returns (N, ncep) int32."""
    ops = int_operators(cfg, torch.device("cpu"))
    nf, ncep = cfg.nfilters, min(cfg.nceptrums, cfg.nfilters)
    N = power.shape[0]
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


def int_tail_model(frames: torch.Tensor, cfg: MFCCConfig = MFCCConfig()
                   ) -> torch.Tensor:
    """K3's function through the warp schedule: (N, 512) int32
    pre-emphasized frames -> (N, ncep) int32."""
    win = int_ops.window_int(frames, cfg.nfft, cfg.window_precision,
                             cfg.width)
    return int_post_power_model(int_ladder_power_model(win), cfg)


# -- float: the packed FFT, unpack, mel and DCT (fladder_stages.cuh) -----------

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


def float_tail_model(frames64: torch.Tensor, ops: LadderOperators,
                     cfg: MFCCConfig, mel_floor: float = 0.0
                     ) -> torch.Tensor:
    """K1's tail through the warp schedule on (N, nfft) float64
    pre-emphasized frames: window * 1/nfft, packing, the spectrum model,
    |X|^2, the mel sums a lane per filter over its band (band offsets,
    ascending bins), floor, log2, the DCT a lane per cepstrum.  (N, ncep)
    f32."""
    y = frames64 * ops.window
    z = torch.complex(y[:, 0::2], y[:, 1::2])
    X = float_spectrum_model(z, cfg.nfft)
    power = X.real * X.real + X.imag * X.imag
    nf = ops.mel.shape[1]
    lo, hi = ops.band[:, 0].long(), ops.band[:, 1].long()
    acc = torch.zeros((power.shape[0], nf), dtype=torch.float64)
    for t in range(int((hi - lo).max())):
        live = lo + t < hi
        kk = torch.clamp(lo + t, max=power.shape[1] - 1)
        term = power[:, kk] * ops.mel[kk, torch.arange(nf)]
        acc = torch.where(live, acc + term, acc)
    if mel_floor:
        acc = torch.clamp_min(acc, mel_floor)
    return (torch.log2(acc) @ ops.dct).to(torch.float32)
