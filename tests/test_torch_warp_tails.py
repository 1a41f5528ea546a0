"""The warp schedules of the shared kernel tails, modelled in torch
(``mfcc_tpu_torch.ops.warp_tails``) with the kernels' index formulas, on
the CPU: every exchange is a permutation of the frame's points and free of
bank conflicts where the kernels' notes say so; the passes perform each
butterfly of the standard plan once (the DCT ladder skips only butterflies
whose inputs are zero or whose outputs no lane keeps); the INT schedule
equals the ``int_ops`` chain and JAX ``mfcc_tpu`` element for element; the
float schedule's spectrum is within 1e-12 of ``torch.fft.rfft`` in float64
and its cepstra within KERNEL_TOL of ``ladder_tail_plain``; the persistent
grid's walk (K1, K7, K2, K3-v1, K3) takes every frame once, with the loop
bounds the kernels' sources hold.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import mfcc_tpu

from mfcc_tpu_torch import MFCCConfig, MIC_CONFIG, tables
from mfcc_tpu_torch.ops import fladder, int_ops, warp_tails as wt

KERNEL_TOL = 5e-5     # kernel vs plain version, both float64 inside
SPECTRUM_TOL = 1e-12  # two float64 FFTs of unit-scale frames

INT_CONFIGS = {
    "default": (MFCCConfig(), mfcc_tpu.DEFAULT_CONFIG),
    "mic": (MIC_CONFIG, mfcc_tpu.MIC_CONFIG),
    "nfilters16": (MFCCConfig(nfilters=16, nceptrums=16),
                   mfcc_tpu.MFCCConfig(nfilters=16, nceptrums=16)),
}
NFFTS = [256, 512, 1024]


def _pairs(i0, i1, tw):
    return sorted(zip(i0.tolist(), i1.tolist(), tw.tolist()))


# -- INT ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["A", "B", "C"])
def test_int_layouts_are_permutations(name):
    """Each layout holds every point of the frame once; its padded words
    fit the row; A and B put a warp's 32 lanes on 32 banks for every
    register, C on at most two lanes a bank (one pair)."""
    pos = wt.int_layout(name)
    assert sorted(pos.reshape(-1).tolist()) == list(range(wt.INT_NFFT))
    words = wt.int_pad(pos)
    assert int(words.max()) < wt.INT_ROW
    for r in range(pos.shape[1]):
        per_bank = torch.bincount(words[:, r] % 32, minlength=32)
        assert int(per_bank.max()) <= (2 if name == "C" else 1), (name, r)


def test_int_ladder_runs_the_dit_plan_once():
    """The three passes perform exactly the butterflies of
    tables.dit_stage_plan(512), stage by stage, each with its twiddle."""
    got = wt.int_ladder_plan()
    want = tables.dit_stage_plan(wt.INT_NFFT)
    assert len(got) == len(want) == 9
    for s, (g, w) in enumerate(zip(got, want)):
        assert _pairs(*g) == _pairs(*(torch.as_tensor(a) for a in w)), s


@pytest.mark.parametrize("nf", [16, 32])
def test_int_dct_ladder_skips_only_provable_zeros(nf):
    """The DCT ladder's butterflies: those the kernel runs and those it
    skips are disjoint and together the plan of tables.dit_stage_plan(4nf);
    a skipped butterfly lies in the lower half, which holds zeros until the
    last stage, or is a last-stage one beyond lane 31 (bins >= 32, never
    kept)."""
    ran, skipped = wt.int_dct_plan(nf)
    plan = tables.dit_stage_plan(4 * nf)
    h = 2 * nf
    for s, (r, k, w) in enumerate(zip(ran, skipped, plan)):
        a, b = _pairs(*r), _pairs(*k)
        assert not set(a) & set(b)
        assert sorted(a + b) == _pairs(*(torch.as_tensor(x) for x in w)), s
        if s < len(plan) - 1:
            assert all(i1 < h for _, i1, _ in b)
        else:
            assert all(i0 >= 32 for i0, _, _ in b)
    # the lower half is zero: bit-reversed storage puts the scattered
    # log-mel row's nonzero (odd) points in the upper half
    rev = tables.bit_reverse_permutation(4 * nf)
    assert all(rev[i] % 2 == 0 for i in range(h))


@pytest.mark.parametrize("name", sorted(INT_CONFIGS))
def test_int_schedule_equals_chain_and_jax(name):
    """The scheduled INT tail equals the int_ops chain and JAX
    ``MFCC().int_frames`` element for element, on tonal, full-range int16
    and int32 frames outside the int16 range (the window wraps)."""
    cfg, jcfg = INT_CONFIGS[name]
    rng = np.random.default_rng(7)
    t = np.arange(4 * 512) / 16000.0
    tone = np.round(9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t))
    frames = np.concatenate([
        tone.reshape(4, 512),
        rng.integers(-32768, 32768, (3, 512)),
        rng.integers(-2 ** 31, 2 ** 31, (2, 512)),
        np.zeros((1, 512)),
    ]).astype(np.int32)
    x = torch.from_numpy(frames)
    got = wt.int_tail_model(x, cfg)
    assert got.dtype == torch.int32 and got.shape == (10, cfg.nceptrums)
    assert torch.equal(got, int_ops.mfcc_int_frames(x, cfg))
    with jax.default_device(jax.devices("cpu")[0]):
        want = np.asarray(mfcc_tpu.MFCC(jcfg).int_frames(frames))
    assert np.array_equal(got.numpy(), want)


# -- the persistent walk ------------------------------------------------------

# (S, F) of the batch kernels and M rows of the frames kernels: S*F not a
# multiple of 8, F = 1, S = 1, a headline-length stream, and more frames
# than the smallest grid's 16 resident warps by more than 100x
WALKS = {"3x5": (3, 5), "F=1": (13, 1), "S=1": (1, 21), "1x374": (1, 374),
         "7x374": (7, 374), "rows M=5": (1, 5), "rows M=1": (1, 1),
         "rows M=1700": (1, 1700)}


@pytest.mark.parametrize("name", sorted(WALKS))
@pytest.mark.parametrize("sms,per_sm", [(2, 1), (4, 3), (132, 3), (3, 0)])
def test_persistent_walk_takes_every_frame_once(name, sms, per_sm):
    """The persistent grid's warps (``warp_tails.persistent_walk``, the
    kernels' loop bounds) take every flat frame G = s*F + g exactly once,
    with its stream, its frame and the ``first`` flag (g == 0, the
    signal's start), each warp's frames in ascending order and no two
    warps more than one frame apart; for the grid the occupancy gives
    (smaller than the tile count, or all the tiles) and for a grid larger
    than the tile count (idle blocks)."""
    S, F = WALKS[name]
    frames = S * F
    tiles = -(-frames // wt.FRAMES_PER_BLOCK)
    grid = wt.persistent_grid(tiles, sms, per_sm)
    assert 1 <= grid <= tiles and grid == min(tiles, sms * max(per_sm, 1))
    for g_ in (grid, tiles + 3):
        walk = wt.persistent_walk(frames, F, g_)
        assert sorted(G for _, _, G, *_ in walk) == list(range(frames))
        per_warp = {}
        for b, w, G, s_, g, first in walk:
            assert 0 <= b < g_ and 0 <= w < wt.FRAMES_PER_BLOCK
            assert s_ * F + g == G and 0 <= g < F and 0 <= s_ < S
            assert first == (g == 0)
            per_warp.setdefault((b, w), []).append(G)
        for seq in per_warp.values():
            assert seq == sorted(seq)
        counts = [len(v) for v in per_warp.values()]
        warps = g_ * wt.FRAMES_PER_BLOCK
        assert max(counts) - (min(counts) if len(counts) == warps else 0) <= 1


@pytest.mark.parametrize("source,loops", [("fladder.cu", 1), ("f64ish.cu", 2),
                                          ("int_mfcc.cu", 2)])
def test_persistent_walk_is_the_kernels_loop(source, loops):
    """The model's loop is the kernels' own: each persistent kernel of K1,
    K7 (audio and frames) and K2/K3-v1/K3 walks G from blockIdx.x * kFrames
    + the warp by gridDim.x * kFrames, and K1's and K7's batch kernels and
    K2's take (s, g) = (G / F, G - s*F) and the frame before the start as 0
    where g == 0; every launch goes through ``launch_persistent``
    (persistent.cuh), whose grid is ``persistent_grid``'s."""
    csrc = Path(wt.__file__).resolve().parent.parent / "csrc"
    text = (csrc / source).read_text()
    assert re.search(r"persistent_grid\(kernel, threads, smem, tiles, &grid\)",
                     (csrc / "persistent.cuh").read_text())
    head = re.findall(
        r"for \(long long (\w+) = static_cast<long long>\(blockIdx\.x\) \* "
        r"kFrames \+ threadIdx\.x / kLanes;\s*\1 < (\w+); \1 \+= "
        r"static_cast<long long>\(gridDim\.x\) \* kFrames\)", text)
    assert len(head) == loops, head
    assert "launch_persistent(" in text
    if source != "int_mfcc.cu":
        assert "const long long s = G / F;" in text
        assert "g > 0 || m > 0" in text
    else:
        assert "const long long s = G / F;" in text
        assert "g == 0" in text


# -- float --------------------------------------------------------------------

@pytest.mark.parametrize("nfft", NFFTS)
def test_float_layouts_are_conflict_free_permutations(nfft):
    """Every pass's layout holds every point once, and each 8-lane phase of
    a 16-byte access (the passes' reads and writes, the unpack's Z[k]
    reads) hits 8 distinct 16-byte slots of 128 bytes; the swizzle is a
    permutation of the row."""
    M = nfft // 2
    log2p = int(np.log2(M // wt.LANES))
    idx = torch.arange(M)
    assert sorted(wt.slot(idx).tolist()) == list(range(M))
    for b, _ in wt.float_passes(log2p):
        pos = wt.float_layout(log2p, b)
        assert sorted(pos.reshape(-1).tolist()) == list(range(M))
        phases = wt.slot(pos).reshape(4, 8, -1) % 8
        for q in range(4):
            for r in range(phases.shape[2]):
                assert len(set(phases[q, :, r].tolist())) == 8, (b, q, r)
    log2m = int(np.log2(M))
    k = torch.arange(M // 2).reshape(-1, 32)             # u, lane
    rev = torch.as_tensor([int(f"{v:0{log2m}b}"[::-1], 2)
                           for v in k.reshape(-1).tolist()]).reshape(k.shape)
    phases = wt.slot(rev).reshape(k.shape[0], 4, 8) % 8
    assert all(len(set(p.tolist())) == 8 for p in phases.reshape(-1, 8))


@pytest.mark.parametrize("nfft", NFFTS)
def test_float_passes_run_the_dif_plan_once(nfft):
    """The passes perform each radix-2 DIF butterfly once, stages in
    descending span, each with its twiddle W_(2^(t+1))^(i mod 2^t); the
    pass sizes are 2+2+2+1, 3+3+2 and 4+4+1 stages."""
    M = nfft // 2
    log2p = int(np.log2(M // wt.LANES))
    log2m = int(np.log2(M))
    plan = wt.float_fft_plan(log2p)
    assert [t for t, *_ in plan] == list(range(log2m - 1, -1, -1))
    sizes = [hi - b for b, hi in wt.float_passes(log2p)]
    assert sizes == {256: [2, 2, 2, 1], 512: [3, 3, 2],
                     1024: [4, 4, 1]}[nfft]
    for t, i0, i1, j in plan:
        i = torch.arange(M)
        lo = i[(i & (1 << t)) == 0]
        want = sorted(zip(lo.tolist(), (lo + (1 << t)).tolist(),
                          (lo & ((1 << t) - 1)).tolist()))
        assert _pairs(i0, i1, j) == want, t


def _unit_frames(nfft, n=6, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1.0, 1.0, (n, nfft)))


@pytest.mark.parametrize("nfft", NFFTS)
def test_float_schedule_spectrum_matches_rfft(nfft):
    cfg = MFCCConfig(nfft=nfft, step=nfft // 3 * 2 // 2)
    ops = fladder.default_operators(cfg, torch.device("cpu"))
    y = _unit_frames(nfft, seed=nfft) * ops.window
    X = wt.float_spectrum_model(torch.complex(y[:, 0::2], y[:, 1::2]), nfft)
    want = torch.fft.rfft(y, dim=-1)[:, : nfft // 2]
    assert float((X - want).abs().max()) <= SPECTRUM_TOL


@pytest.mark.parametrize("nfft", NFFTS)
def test_float_schedule_cepstra_match_plain(nfft):
    """Cepstra of int16-scale and silent frames (with a mel floor) within
    KERNEL_TOL of the tail's plain version."""
    cfg = MFCCConfig(nfft=nfft, step=nfft // 3 * 2 // 2)
    ops = fladder.default_operators(cfg, torch.device("cpu"))
    frames = torch.round(_unit_frames(nfft, seed=nfft + 1) * 30000)
    got = wt.float_tail_model(frames, ops, cfg)
    want = fladder.ladder_tail_plain(frames, ops, cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= KERNEL_TOL
    silent = torch.zeros(2, nfft, dtype=torch.float64)
    got = wt.float_tail_model(silent, ops, cfg, mel_floor=1.0)
    assert torch.equal(got, fladder.ladder_tail_plain(silent, ops, cfg, 1.0))
