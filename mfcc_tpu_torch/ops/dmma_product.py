"""The host side and a torch model of the FP64 tensor-core product engine
(``csrc/dmma_product.cuh``) that K8 (``dense_fused``) and the split-DFT
kernels K5, K5-frames and K4-split (``float_fused``, ``stream_fused``)
run their DFT products on.

The engine computes D[col, sig] = sum_k A[k, col] x[sig, k] for a tile of
signal rows x against a (K, N) operator A that the block's warps stream
by TMA (1-D bulk copies) into a ring of shared buffers, ``chunk_rows``
rows a chunk.  The wrapper hands A in *fragment order*: the order in which the
kernel's lanes read their ``mma.sync`` A fragments, so a chunk is one
contiguous copy and a lane's fragment one vector load.  This module builds
those layouts (``fragment_order``, ``lo_fragment_order``, ``operator``)
and states the kernel's index formulas -- which block of the persistent
grid takes which tile, which lane and fragment value reads which operator
element and which signal element, which accumulator holds which output,
which ring stage and parity each chunk uses -- so the CPU tests can check
that every (signal, column) pair sums every k once, that every frame is
stored once, and that the ring's waits pair up.  ``product_model`` runs the product with the
kernel's summation order (the lo*lo correction of K5 at 3 passes summed in
f32 per 16-deep step) for the accuracy test.  No route runs the models.

``KSTEP`` and ``OP_DTYPE`` name the layout the header's ``kKStep`` and
``OpT`` read (m16n8k4 fragments of an f32 operator); a CPU test holds them
to the header.  The chunk size is the wrappers' choice: the C entries take
``chunk_rows``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

KSTEP = 4                     # FP64 MMA depth, m16n8k4 (kKStep)
OP_DTYPE = torch.float32      # the streamed FP64-product operator (OpT)
OP_BYTES = 4                  # its element size
STAGE_BYTES = 16384           # least bytes of a ring chunk (K5)
CONSUMER_WARPS = 8
LANES = 32


def dense_stage_bytes(N: int) -> int:
    """K8's chunk: 16 rows (four MMA steps between releases), at most
    32 KB."""
    return min(32768, 16 * N * OP_BYTES)


def chunk_rows(N: int, stage_bytes: int = STAGE_BYTES) -> int:
    """Operator rows per ring chunk for N columns: stage_bytes worth, and
    at least one MMA step."""
    return max(KSTEP, stage_bytes // (N * OP_BYTES))


def padded_rows(K: int, N: int, stage_bytes: int = STAGE_BYTES) -> int:
    """K rounded up to whole chunks (the pad rows are zero)."""
    kc = chunk_rows(N, stage_bytes)
    return -(-K // kc) * kc


# -- layouts -----------------------------------------------------------------------

def fragment_order(op: torch.Tensor, rows: int | None = None
                   ) -> torch.Tensor:
    """(K, N) operator -> flat OP_DTYPE tensor of rows (default
    padded_rows(K, N)) * N values in fragment order, zero past K: k = 4 ks
    + t, column n = 16 ct + 8h + g at offset ((ks * N/16 + ct) * 32 + 4g +
    t) * 2 + h, the value h of lane 4g + t's A fragment of column tile ct
    at step ks.  N must be a multiple of 16."""
    K, N = op.shape
    rows = padded_rows(K, N) if rows is None else rows
    x = op.new_zeros((rows, N), dtype=OP_DTYPE)
    x[:K] = op.to(OP_DTYPE)
    x = x.reshape(rows // KSTEP, 4, N // 16, 2, 8)       # ks t ct h g
    return x.permute(0, 2, 4, 1, 3).contiguous().reshape(-1)


def lo_fragment_order(lo: torch.Tensor) -> torch.Tensor:
    """(K, N) bf16 lo limbs (K a multiple of 16) -> flat bf16 tensor in the
    order of the m16n8k16 bf16 A fragments: k = 16 ks + 8q + 2t + e, n = 16
    ct + 8h + g at offset ((ks * N/16 + ct) * 32 + 4g + t) * 8 + 2(2q + h)
    + e (register 2q + h of lane 4g + t, element e)."""
    K, N = lo.shape
    x = lo.to(torch.bfloat16).reshape(K // 16, 2, 4, 2, N // 16, 2, 8)
    return x.permute(0, 4, 6, 2, 1, 5, 3).contiguous().reshape(-1)


class Operator(NamedTuple):
    """An operator as the kernels take it: the flat buffer (at 3 passes the
    bf16 lo chunks, then the FP64-product chunks, as raw bytes), its
    padded rows and the FP64-product chunk rows."""
    data: torch.Tensor
    rows: int
    chunk_rows: int

    def args(self) -> tuple:
        """(data, rows, chunk_rows): the C entry points' operator
        arguments."""
        return self.data.data_ptr(), self.rows, self.chunk_rows


def operator(op: torch.Tensor, lo: torch.Tensor | None = None,
             stage_bytes: int = STAGE_BYTES) -> Operator:
    """The engine operator of a (K, N) product operator (values exact in
    OP_DTYPE) in chunks of stage_bytes and, for K5 at 3 passes, its (K, N)
    bf16 lo limbs, whose chunks come first in the buffer."""
    K, N = op.shape
    rows = padded_rows(K, N, stage_bytes)
    main = fragment_order(op, rows).view(torch.uint8)
    if lo is not None:
        main = torch.cat([lo_fragment_order(lo).view(torch.uint8), main])
    return Operator(main, rows, chunk_rows(N, stage_bytes))


class MelTable(NamedTuple):
    """A mel matrix's band weights as the engine kernels keep them in
    shared memory: filter m's weights mel[lo_m .. hi_m - 1, m] at
    weights[offsets[m] ..], with [lo, hi) the band of
    ``fladder.mel_bands``."""
    weights: torch.Tensor    # (sum of band widths,)
    offsets: torch.Tensor    # (nfilters,) int32

    def args(self) -> tuple:
        """(weights, offsets, length): the C entry points' arguments."""
        return (self.weights.data_ptr(), self.offsets.data_ptr(),
                self.weights.numel())


def mel_table(mel: torch.Tensor) -> MelTable:
    """The band weights of an (nbins, nfilters) mel matrix, in its dtype on
    its device (built on the host: the length sizes the kernels' shared
    memory)."""
    m = mel.detach().cpu().numpy()
    nz = m != 0
    lo = nz.argmax(axis=0)
    hi = m.shape[0] - nz[::-1].argmax(axis=0)
    w = np.concatenate([m[a:b, j] for j, (a, b) in enumerate(zip(lo, hi))])
    off = np.concatenate([[0], np.cumsum(hi - lo)[:-1]]).astype(np.int32)
    return MelTable(torch.as_tensor(w).to(mel.device),
                    torch.as_tensor(off).to(mel.device))


# -- the kernel's schedule ---------------------------------------------------------------

def block_tiles(ntiles: int, resident: int) -> list:
    """Per block of a launch over ``ntiles`` tiles on a card that holds
    ``resident`` blocks at once, the tiles it takes in order: the grid is
    min(ntiles, resident) blocks (``persistent_grid``) and block b takes
    b, b + grid, ... for ``turns(ntiles)`` turns."""
    grid = min(ntiles, resident)
    return [[b + i * grid for i in range(-(-(ntiles - b) // grid))]
            for b in range(grid)]


def a_offset(warp: int, lane, j: int, ks: int, v, ct_per_warp: int,
             ncol_tiles: int):
    """The kernel's read of A fragment value v of tile j of ``warp`` at step
    ks, within the chunks' buffer (fp64_chunks: st + (warp CT 32 + lane)
    2, + ks ncol 32 2, + j 32 2, + v)."""
    return (((ks * ncol_tiles + warp * ct_per_warp + j) * LANES + lane) * 2
            + v)


def a_element(warp: int, lane, j: int, ks: int, v, ct_per_warp: int):
    """(k, column) that value v of lane's A fragment stands for in the
    m16n8k4 .f64 MMA: row g + 8v of the column tile, depth t."""
    g, t = lane // 4, lane % 4
    col = 16 * (warp * ct_per_warp + j) + g + 8 * v
    return KSTEP * ks + t + 0 * col, col


def b_element(lane, n: int, ks: int):
    """(signal, k) of lane's B value of signal tile n at step ks."""
    g, t = lane // 4, lane % 4
    return 8 * n + g, KSTEP * ks + t


def d_element(warp: int, lane, j: int, n: int, c, ct_per_warp: int):
    """(column, signal) of accumulator acc[j][n][c] of lane in warp."""
    g, t = lane // 4, lane % 4
    return (16 * (warp * ct_per_warp + j) + g + 8 * (c // 2),
            8 * n + 2 * t + c % 2)


def ring_slots(total: int, stages: int) -> list:
    """(stage, parity the consumers wait for on full, parity of the empty
    phase whose completion lets the chunk be issued) of chunks 0 .. total -
    1: chunk c is fill k = c / stages of stage c % stages, waited for at
    parity k & 1 and issued once the release of fill k - 1 completed
    (try_issue; the phase before a barrier's first counts as complete)."""
    return [(i % stages, (i // stages) & 1, ((i // stages) & 1) ^ 1)
            for i in range(total)]


def simulate_ring(total: int, stages: int, consumers: int) -> list:
    """Run the ring's protocol with mbarrier semantics (a phase completes
    when its arrivals are in; try_wait.parity(p) passes once the phase of
    parity p has completed, the phase before a barrier's first counting
    as completed), each chunk issued once when its turn comes (the claim
    of try_issue), the consumer warps in turn: returns, per consumer, the
    chunk it found in each stage it read.  Raises if a wait never passes
    (a deadlock) or a chunk is overwritten before every consumer has
    released it."""
    full_phase = [0] * stages      # completed phases
    empty_phase = [0] * stages
    empty_count = [0] * stages
    data = [None] * stages
    readers = [set() for _ in range(stages)]
    seen = [[] for _ in range(consumers)]
    pos = [0] * consumers
    produced = 0

    while min(pos) < total:
        progress = False
        if produced < total:
            s, _, pe = ring_slots(total, stages)[produced]
            if _parity_passed(empty_phase[s], pe):
                if data[s] is not None and readers[s] != set(range(consumers)):
                    raise RuntimeError(f"chunk {data[s]} overwritten")
                data[s], readers[s] = produced, set()
                full_phase[s] += 1
                produced += 1
                progress = True
        for c in range(consumers):
            if pos[c] >= total:
                continue
            s, pf, _ = ring_slots(total, stages)[pos[c]]
            if _parity_passed(full_phase[s], pf):
                seen[c].append(data[s])
                readers[s].add(c)
                empty_count[s] += 1
                if empty_count[s] == consumers:
                    empty_count[s] = 0
                    empty_phase[s] += 1
                pos[c] += 1
                progress = True
        if not progress:
            raise RuntimeError("the ring deadlocks")
    return seen


def _parity_passed(completed: int, parity: int) -> bool:
    """try_wait.parity(parity) on a barrier that has completed `completed`
    phases: the current phase has parity completed % 2; a wait for the
    current phase's parity blocks, for the other parity it passes."""
    return completed % 2 != parity


# -- the product, in the kernel's order ------------------------------------------------

def product_model(x: torch.Tensor, op: torch.Tensor,
                  lo_x: torch.Tensor | None = None,
                  lo_op: torch.Tensor | None = None) -> torch.Tensor:
    """(S, K) float64 signal rows x (K, N) float64 operator in the engine's
    order: at 3 passes (lo_x, lo_op the bf16 lo limbs as float tensors) the
    f32 sum of the lo*lo products, 16 k a step, each step's exact products
    summed in float64 and rounded to f32 before the f32 add (the tensor
    core's f32 accumulation), negated as the accumulator's start; then
    k = 0, 1, ... one product and float64 add each.  Returns the (S, N)
    float64 accumulators before the kernel's rounding to f32.  Every
    element is computed by the same elementwise operations, so its bits do
    not depend on its row or column."""
    S, K = x.shape
    acc = x.new_zeros((S, op.shape[1]), dtype=torch.float64)
    if lo_x is not None:
        corr = torch.zeros_like(acc, dtype=torch.float32)
        lx, lc = lo_x.double(), lo_op.double()
        for k0 in range(0, K, 16):
            step = torch.zeros_like(acc)
            for k in range(k0, min(k0 + 16, K)):
                step = step + lx[:, k, None] * lc[None, k, :]
            corr = corr + step.to(torch.float32)
        acc = -corr.double()
    for k in range(K):
        acc = acc + x[:, k, None] * op[None, k, :]
    return acc
