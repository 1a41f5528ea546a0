"""The FP64 tensor-core product engine (``csrc/dmma_product.cuh``) through
its torch model (``mfcc_tpu_torch.ops.dmma_product``): the fragment-order
layouts the wrappers build against the kernels' read formulas and the
MMA's fragment semantics, the persistent grid's tile schedule, the
mbarrier ring's parities, the layout constants against the header, the
cache of caller-given operators, and the K5 product with its lo*lo correction summed in f32 held
to ``split_dft_plain``'s float64 sum within the bound the source states.

CPU only: the kernels themselves run in ``tests/test_torch_cuda.py``."""

import pathlib
import re

import numpy as np
import pytest
import torch

from mfcc_tpu_torch import MFCCConfig
from mfcc_tpu_torch.ops import dense_fused, dmma_product as dp, float_fused

# (what, K, N, columns a warp owns in tiles of 16): K8 at nfft 256/512/1024
# and the folded K = 513; K5's nh x nh product at nfft 256/512/1024
SHAPES = [("K8 nfft 256", 256, 256, 2), ("K8 nfft 512", 512, 512, 4),
          ("K8 nfft 1024", 1024, 1024, 8), ("K8 folded 513", 513, 512, 4),
          ("K5 nfft 256", 128, 128, 1), ("K5 nfft 512", 256, 256, 2),
          ("K5 nfft 1024", 512, 512, 4)]


def kernel_view(buf: torch.Tensor, rows: int, N: int, ct: int):
    """The (rows, N) operator as the kernel's lanes read it from the
    fragment-order buffer, and how often each element is read."""
    ncol = N // 16
    assert ncol == dp.CONSUMER_WARPS * ct
    lane = torch.arange(dp.LANES)[:, None]
    v = torch.arange(2)[None, :]
    got = torch.full((rows, N), float("nan"), dtype=torch.float64)
    reads = torch.zeros((rows, N), dtype=torch.int64)
    for ks in range(rows // dp.KSTEP):
        for w in range(dp.CONSUMER_WARPS):
            for j in range(ct):
                off = dp.a_offset(w, lane, j, ks, v, ct, ncol)
                k, col = dp.a_element(w, lane, j, ks, v, ct)
                got[k, col] = buf[off].double()
                reads.index_put_((k.reshape(-1), col.reshape(-1)),
                                 torch.ones(k.numel(), dtype=torch.int64),
                                 accumulate=True)
    return got, reads


@pytest.mark.parametrize("what,K,N,ct", SHAPES)
def test_layout_is_what_the_kernel_reads(what, K, N, ct):
    """Every operator element, zero pad rows included, is read once by the
    lane and fragment value that the MMA takes it from."""
    op = torch.arange(K * N, dtype=torch.float64).reshape(K, N) + 1
    buf = dp.fragment_order(op)
    rows = dp.padded_rows(K, N)
    assert rows % dp.chunk_rows(N) == 0 and 0 <= rows - K < dp.chunk_rows(N)
    assert buf.numel() == rows * N
    got, reads = kernel_view(buf, rows, N, ct)
    assert bool((reads == 1).all()), what
    assert torch.equal(got[:K], op.to(dp.OP_DTYPE).double())
    assert not bool(got[K:].any())


def test_layout_constants_match_header():
    """The layout the wrappers build is the one the kernels read: KSTEP,
    OP_DTYPE and the warps a block in ``ops/dmma_product.py`` are kKStep,
    OpT and kConsumerWarps in ``csrc/dmma_product.cuh``."""
    src = (pathlib.Path(dp.__file__).parent.parent / "csrc"
           / "dmma_product.cuh").read_text()
    assert re.search(r"constexpr int kKStep = (\d+);", src)[1] == str(dp.KSTEP)
    assert re.search(r"constexpr int kConsumerWarps = (\d+);", src)[1] == \
        str(dp.CONSUMER_WARPS)
    opt = re.search(r"using OpT = (\w+);", src)[1]
    assert {"float": torch.float32, "double": torch.float64}[opt] == dp.OP_DTYPE
    assert torch.empty((), dtype=dp.OP_DTYPE).element_size() == dp.OP_BYTES


@pytest.mark.parametrize("what,K,N,ct", SHAPES)
def test_every_pair_sums_every_k_once(what, K, N, ct):
    """Over the tile's chunks, steps, warps, column tiles and signal tiles,
    the MMAs' fragments (A from the operator, B from the signal rows, D the
    accumulators) give each (column, signal) every k of the padded K
    exactly once, and no accumulator two (column, signal) pairs."""
    rows = dp.padded_rows(K, N)
    NT = 64 // (4 * ct)                    # 64 FP64 accumulators a thread
    S = 8 * NT
    lane = torch.arange(dp.LANES)
    count = torch.zeros((N, S, rows), dtype=torch.int32)
    owner = torch.full((N, S), -1, dtype=torch.int64)
    for ks in range(rows // dp.KSTEP):
        ka = {int(k) for k in dp.a_element(0, lane[:, None], 0, ks,
                                           torch.arange(2), ct)[0]
              .reshape(-1)}
        sig, kb = dp.b_element(lane, 0, ks)
        assert ka == set(kb.reshape(-1).tolist())   # A and B agree on k
        ks_k = torch.tensor(sorted(ka))
        for w in range(dp.CONSUMER_WARPS):
            for j in range(ct):
                for n in range(NT):
                    col, s = dp.d_element(w, lane[:, None], j, n,
                                          torch.arange(4)[None, :], ct)
                    col, s = col.reshape(-1), s.reshape(-1)
                    assert len(set(zip(col.tolist(), s.tolist()))) == 128
                    count[col[:, None], s[:, None], ks_k[None, :]] += 1
                    if ks == 0:
                        acc = (w * ct + j) * NT + n
                        assert bool((owner[col, s] == -1).all())
                        owner[col, s] = acc
    assert bool((count == 1).all()), what
    assert bool((owner >= 0).all())


@pytest.mark.parametrize("nh", [128, 256, 512])
def test_lo_layout_is_what_the_kernel_reads(nh):
    """The bf16 lo limbs of K5's correction in the m16n8k16 A-fragment
    order: register r, element e of lane (g, t) at column tile ct, step ks
    is column 16 ct + g + 8 (r & 1), k 16 ks + 2t + 8 (r >> 1) + e."""
    lo = torch.arange(nh * nh, dtype=torch.float32).reshape(nh, nh) % 251
    buf = dp.lo_fragment_order(lo).float()
    ncol = nh // 16
    g, t = torch.arange(32) // 4, torch.arange(32) % 4
    seen = torch.zeros((nh, nh), dtype=torch.int32)
    for ks in range(nh // 16):
        for ct in range(ncol):
            for r in range(4):
                for e in range(2):
                    off = ((ks * ncol + ct) * 32 + 4 * g + t) * 8 + 2 * r + e
                    k = 16 * ks + 2 * t + 8 * (r >> 1) + e
                    col = 16 * ct + g + 8 * (r & 1)
                    assert torch.equal(buf[off], lo[k, col])
                    seen[k, col] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("nfft,passes", [(256, 3), (512, 3), (512, 4),
                                         (512, 6), (1024, 3)])
def test_k5_engine_operator(nfft, passes):
    """K5's buffer: at 3 passes the bf16 lo chunks, then hi + lo (the f32
    values at 6) in fragment order, whole chunks of the same bytes, as the
    kernel's geometry counts them."""
    cfg = MFCCConfig(nfft=nfft, step=nfft // 3 // 2 * 2)
    ops = float_fused.default_operators(cfg, torch.device("cpu"))
    eng = float_fused.engine_operator_of(ops.dft, passes)
    nh = nfft // 2
    stage = eng.chunk_rows * nh * dp.OP_BYTES
    assert eng.rows == nh and nh % eng.chunk_rows == 0
    lo_bytes = nh * nh * 2 if passes == 3 else 0
    assert eng.data.numel() == lo_bytes + nh * nh * dp.OP_BYTES
    assert lo_bytes % stage == 0 and (stage // (2 * nh)) % 16 == 0
    hi, lo = float_fused._limbs(ops.dft.T.contiguous())
    main = eng.data[lo_bytes:].view(dp.OP_DTYPE)
    got, _ = kernel_view(main, nh, nh, nh // 128)
    want = ops.dft.T if passes == 6 else hi + lo
    assert torch.equal(got, want.double())
    if passes == 3:
        assert torch.equal(eng.data[:lo_bytes].view(torch.bfloat16),
                           dp.lo_fragment_order(lo))


@pytest.mark.parametrize("fold", [False, True])
def test_k8_engine_operator(fold):
    """K8's buffer is CS (CS2 folded, limb sums when split) with its
    columns in re/im tile pairs, K padded with zero rows to whole chunks."""
    cfg = MFCCConfig()
    ops = dense_fused.dense_operators(cfg, torch.device("cpu"), fold, True)
    K, N = ops.cs.shape
    perm = dense_fused.engine_columns(N)
    assert sorted(perm.tolist()) == list(range(N))
    assert ops.engine.chunk_rows == dp.chunk_rows(N, dp.dense_stage_bytes(N))
    assert ops.engine.rows % ops.engine.chunk_rows == 0
    assert 0 <= ops.engine.rows - K < ops.engine.chunk_rows
    got, _ = kernel_view(ops.engine.data.view(dp.OP_DTYPE),
                         ops.engine.rows, N, N // 128)
    assert torch.equal(got[:K], ops.cs[:, perm].double())
    assert not bool(got[K:].any())
    # tile 2i: cos of bins 16i.., tile 2i + 1: -sin of the same bins
    tiles = perm.reshape(-1, 16)
    assert torch.equal(tiles[1::2], tiles[0::2] + N // 2)


@pytest.mark.parametrize("ntiles,resident",
                         [(1, 132), (7, 3), (12, 8), (13, 132), (374, 66),
                          (2737, 132), (5, 1)])
def test_block_tiles_cover_once(ntiles, resident):
    """Every tile is taken once; no block of the persistent grid is idle,
    and the blocks' turns differ by at most one (the producer streams each
    block its own turns' chunks)."""
    per_block = dp.block_tiles(ntiles, resident)
    assert len(per_block) == min(ntiles, resident)
    taken = sorted(t for blk in per_block for t in blk)
    assert taken == list(range(ntiles))
    turns = [len(blk) for blk in per_block]
    assert min(turns) >= 1 and max(turns) - min(turns) <= 1


@pytest.mark.parametrize("S,F,FT,resident", [(3, 374, 32, 132), (1, 5, 32, 132),
                                             (4096, 7, 32, 132), (5, 53, 16, 4)])
def test_ragged_tiles_store_each_frame_once(S, F, FT, resident):
    """The stores of a launch, as the kernels make them: K5's flattened
    tiles store frames G0 + f < S F, K8's per-stream tiles frames f0 + f <
    F.  Every frame is stored once, the ragged ends' slots not at all."""
    M = S * F
    k5 = torch.zeros(M, dtype=torch.int32)
    ntiles = -(-M // FT)
    for blk in dp.block_tiles(ntiles, resident):
        for tile in blk:
            G = tile * FT + torch.arange(FT)
            k5[G[G < M]] += 1
    assert bool((k5 == 1).all())
    k8 = torch.zeros((S, F), dtype=torch.int32)
    tps = -(-F // FT)
    for blk in dp.block_tiles(S * tps, resident):
        for tile in blk:
            s, f0 = tile // tps, tile % tps * FT
            g = f0 + torch.arange(FT)
            k8[s, g[g < F]] += 1
    assert bool((k8 == 1).all())


@pytest.mark.parametrize("stages,total", [(2, 8), (3, 11), (4, 14), (4, 3)])
def test_ring_parities(stages, total):
    """The producer's and consumers' wait parities (ring_slots) under
    mbarrier semantics: every consumer warp of the block reads chunks 0,
    1, 2, ... in order, none is overwritten before all have released it,
    and nothing deadlocks (also where a launch streams fewer chunks than
    the ring has stages)."""
    seen = dp.simulate_ring(total, stages, dp.CONSUMER_WARPS)
    assert all(s == list(range(total)) for s in seen)


@pytest.mark.parametrize("field", ["mel", "dft"])
def test_engine_args_follow_in_place_edits(field):
    """Caller-given operators edited in place between two launches: the
    engine's derived operator and mel table are built again from the new
    values, never served stale from the cache."""
    cfg = MFCCConfig()
    cpu = torch.device("cpu")
    d = float_fused.default_operators(cfg, cpu)
    ops = d._replace(dft=d.dft.clone(), mel=d.mel.clone())
    _, (eng0, mel0) = float_fused.engine_args(ops, cfg, cpu, 3)
    _, (eng1, mel1) = float_fused.engine_args(ops, cfg, cpu, 3)
    assert eng1 is eng0 and mel1 is mel0          # unchanged: cached
    getattr(ops, field).mul_(0.5)
    _, (eng2, mel2) = float_fused.engine_args(ops, cfg, cpu, 3)
    if field == "mel":
        assert torch.equal(mel2.weights, mel0.weights * 0.5)
        assert torch.equal(mel2.weights, dp.mel_table(ops.mel).weights)
    else:
        want = float_fused.engine_operator_of(ops.dft, 3)
        assert torch.equal(eng2.data, want.data)
        assert not torch.equal(eng2.data, eng0.data)


def _spread_streams():
    """8 streams of 1 s of the benches' signal (a chirp and a tone plus
    uniform noise, integer-valued)."""
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000.0
    base = (9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
            + 4000 * np.sin(2 * np.pi * 900 * t))
    noise = rng.integers(-1500, 1500, (8, 16000))
    return np.round(np.clip(base + noise, -32768, 32767)).astype(np.int16)


@pytest.mark.parametrize("what", ["spread streams", "full-scale int16"])
def test_k5_lo_correction_within_bound(what):
    """The engine's K5 product at 3 passes, (hi+lo)(hi+lo) in float64 less
    the lo*lo sum taken in f32 (product_model), against the float64 sum of
    split_dft_plain: within nh 2^-24 sum |lo_x lo_c| + nh 2^-52 sum |x c|
    (the bound of radix2_stages.cuh), and after the one rounding to f32
    within that bound and an ulp of split_dft_plain's output."""
    cfg = MFCCConfig()
    sig = (_spread_streams() if what == "spread streams" else
           np.random.default_rng(3).integers(-32768, 32768, (2, 16000))
           .astype(np.int16))
    ops = float_fused.default_operators(cfg, torch.device("cpu"))
    x = torch.from_numpy(sig).float()
    from mfcc_tpu_torch.ops import framing
    fr = framing.extract_frames(framing.preemphasis(x), cfg.nfft, cfg.hop)
    sigs = torch.stack([fr[..., 0::2] * ops.we, fr[..., 1::2] * ops.wo],
                       dim=-2).reshape(-1, cfg.nfft // 2)
    xs, xl = float_fused._operand(sigs, 3)
    cs, cl = float_fused._operand(ops.dft, 3)
    ref = xs @ cs.T - xl @ cl.T
    got = dp.product_model(xs, cs.T.contiguous(), xl, cl.T.contiguous())
    nh = cfg.nfft // 2
    bound = (nh * 2.0 ** -24 * (xl.abs() @ cl.abs().T)
             + nh * 2.0 ** -52 * (xs.abs() @ cs.abs().T))
    ratio = float(((got - ref).abs() / bound).max())
    corr = float(((xl.abs() @ cl.abs().T)
                  / (xs.abs() @ cs.abs().T).clamp_min(1e-300)).max())
    print(f"\n{what}: |engine - float64| / bound max {ratio:.3e}; lo*lo sum "
          f"/ sum |x c| max {corr:.3e} (<= 2^-16 = {2.0 ** -16:.3e})")
    assert ratio <= 1.0
    assert corr <= 2.0 ** -16
    plain = float_fused.split_dft_plain(sigs, ops.dft, 3)
    f32 = got.to(torch.float32)
    ulp = torch.finfo(torch.float32).eps * plain.double().abs()
    assert bool(((f32 - plain).double().abs() <= ulp + bound).all())


def test_two_tile_positions_same_bits():
    """One frame's signals at two positions of a batch (two tiles, two
    rows of a tile) get the same bits from the engine's summation order,
    the correction included."""
    cfg = MFCCConfig()
    ops = float_fused.default_operators(cfg, torch.device("cpu"))
    rng = np.random.default_rng(11)
    rows = torch.from_numpy(rng.integers(-32768, 32768, (70, cfg.nfft // 2))
                            .astype(np.float32)) * ops.we
    rows[61] = rows[2]
    rows[9] = rows[2]
    xs, xl = float_fused._operand(rows, 3)
    cs, cl = float_fused._operand(ops.dft, 3)
    got = dp.product_model(xs, cs.T.contiguous(), xl, cl.T.contiguous())
    assert torch.equal(got[2], got[61]) and torch.equal(got[2], got[9])


@pytest.mark.parametrize("nfft,nfilters", [(256, 32), (512, 32), (512, 16),
                                           (1024, 32)])
def test_mel_table_is_the_band_weights(nfft, nfilters):
    """The engine kernels' mel table: filter m's weights w[k] = melw[moff[m]
    - lo + k] for k in [lo, hi) of ``fladder.mel_bands`` are mel[k, m], the
    filters back to back; outside the band mel is zero."""
    from mfcc_tpu_torch.ops import fladder
    cfg = MFCCConfig(nfft=nfft, nfilters=nfilters, nceptrums=nfilters)
    for mel in (float_fused.default_operators(cfg, torch.device("cpu")).mel,
                dense_fused.dense_operators(cfg, torch.device("cpu"), False,
                                            False).mel):
        table = dp.mel_table(mel)
        band = fladder.mel_bands(mel)
        widths = band[:, 1] - band[:, 0]
        assert table.weights.dtype == mel.dtype
        assert table.offsets.dtype == torch.int32
        assert table.weights.numel() == int(widths.sum())
        assert torch.equal(table.offsets[1:], torch.cumsum(widths, 0)[:-1]
                           .to(torch.int32))
        for m, (lo, hi) in enumerate(band.tolist()):
            w = table.weights[int(table.offsets[m]):][: hi - lo]
            assert torch.equal(w, mel[lo:hi, m])
            assert not bool(mel[:lo, m].any()) and not bool(mel[hi:, m].any())
