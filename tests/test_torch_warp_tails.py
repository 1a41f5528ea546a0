"""The warp schedules of the shared kernel tails, modelled in torch
(``mfcc_tpu_torch.ops.warp_tails``) with the kernels' index formulas, on
the CPU: every exchange is a permutation of the frame's points and free of
bank conflicts where the kernels' notes say so; the passes perform each
butterfly of the standard plan once (the DCT ladder skips only butterflies
whose inputs are zero or whose outputs no lane keeps); the INT schedule
equals the ``int_ops`` chain and JAX ``mfcc_tpu`` element for element; the
float schedule's spectrum is within 1e-12 of ``torch.fft.rfft`` in float64
and its cepstra within KERNEL_TOL of ``ladder_tail_plain``; the persistent
grid's walk (K1, K7, K2, K3-v1, K3, and K10's epilogue with its prefetch)
takes every frame once, with the loop bounds the kernels' sources hold;
the balanced filterbank's schedule (every INT kernel's) holds every term
of the bank once with no lane over ceil(terms / 32) + 2, and the tail on
it equals the chain and JAX.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import mfcc_tpu

from mfcc_tpu_torch import MFCC, MFCCConfig, MIC_CONFIG, tables
from mfcc_tpu_torch.config import KALDI_MFCC_HIRES, KaldiConfig
from mfcc_tpu_torch.ops import fladder, int_fused, int_ops, warp_tails as wt
from mfcc_tpu_torch.ops.int_fused import FB_STEPS

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


@pytest.mark.parametrize("source,loops,framing", [
    ("fladder.cu", 1, "audio"), ("fladder.cu", 1, "rows"),
    ("int_mfcc.cu", 2, "audio")])
def test_persistent_walk_is_the_kernels_loop(source, loops, framing):
    """The model's loop is the kernels' own: the FP64 tail's one walk
    (``tail_walk``: K1, K1-Kaldi, K7 and K7-frames) and K2/K3-v1/K3's two
    persistent kernels walk G from blockIdx.x * kFrames + the warp by
    gridDim.x * kFrames, and every launch goes through
    ``launch_persistent`` (persistent.cuh), whose grid is
    ``persistent_grid``'s.  The audio kernels take (s, g) = (G / F, G -
    s*F) and the frame before the start as 0 where g == 0: in the walk the
    FPGA, Kaldi and K7 ingests, each through ``Scalars::frame``, the one
    division; the frames ingest reads row G, with no division."""
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
    if source == "int_mfcc.cu":
        assert "const long long s = G / F;" in text
        assert "g == 0" in text
        return
    assert text.count("__global__") == 1
    assert text.count("const long long s = G / F;") == 1
    body = {name: text.split(f"struct {name} {{", 1)[1].split("\n};", 1)[0]
            for name in re.findall(r"struct (\w+Ingest) \{", text)}
    audio = ["FpgaIngest", "KaldiIngest", "F64ishIngest"]
    assert sorted(body) == sorted(audio + ["F64ishFramesIngest"])
    if framing == "audio":
        for name in audio:
            assert "a.frame(audio, G, g)" in body[name], name
        assert "g > 0 || m > 0" in body["FpgaIngest"]
        assert "g > 0 || m > 0" in body["F64ishIngest"]
    else:
        rows = body["F64ishFramesIngest"]
        assert "frame(" not in rows and "/ F" not in rows
        assert "frames + G * (64 << LOG2P)" in rows


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


# -- the balanced mel schedule (every kernel on the FP64 tail) -----------------

MEL_BANKS = {
    "fpga256": MFCCConfig(nfft=256, step=86),
    "fpga512": MFCCConfig(),
    "fpga1024": MFCCConfig(nfft=1024, step=340),
    "fpga16": MFCCConfig(nfilters=16, nceptrums=16),
    "kaldi16k": KALDI_MFCC_HIRES,
    "kaldi8k": KaldiConfig(samplerate=8000, nfft=256, window_samples=200,
                           step=80, nfilters=23, nceptrums=13,
                           high_freq=-200.0),
    "kaldi8k40": KaldiConfig(samplerate=8000, nfft=256, window_samples=200,
                             step=80, nfilters=40, nceptrums=40,
                             high_freq=-200.0),
}
MEL_ENTRY = [("w", "<f8"), ("k", "<i4"), ("s", "<i4")]


def _mel_bank(cfg):
    return fladder.fladder_operators(cfg)[1]


def _decode_mel(words, nfilters):
    """(entries (L, 32) {w, k, s}, gather words) of mel_schedule words."""
    L = (len(words) - nfilters) // (32 * 4)
    assert len(words) == L * 128 + nfilters
    ent = words[: L * 128].view(MEL_ENTRY).reshape(L, 32)
    return ent, words[L * 128:].astype(np.int64)


def _schedule_sums(power, words, nfilters):
    """A float64 numpy evaluation of the schedule, as the kernel runs it:
    each lane's sum stored at a segment's last term and restarted from 0,
    then each filter's slots added in order.  (N, nfilters)."""
    ent, gather = _decode_mel(words, nfilters)
    N, M = power.shape
    row = np.zeros((N, 2 * M))
    row[:, :M] = power
    for lane in range(32):
        acc = np.zeros(N)
        for e in ent[:, lane]:
            acc = acc + row[:, e["k"] // 8] * e["w"]
            if e["s"]:
                row[:, e["s"] // 8] = acc
                acc = np.zeros(N)
    out = np.zeros((N, nfilters))
    for j, g in enumerate(gather):
        for q in range(g >> 16):
            out[:, j] = out[:, j] + row[:, (g & 0xFFFF) // 8 + q]
    return out


def _lane_sums(power, mel):
    """A lane per filter over its nonzero bins in ascending order."""
    out = np.zeros((power.shape[0], mel.shape[1]))
    for j in range(mel.shape[1]):
        for k in np.flatnonzero(mel[:, j]):
            out[:, j] = out[:, j] + power[:, k] * mel[k, j]
    return out


def _wide_power(N, M, seed):
    """Power rows spanning ~1e-8 to 1e14, loud and quiet bands side by
    side, as band sums of pre-emphasized int16 audio do."""
    rng = np.random.default_rng(seed)
    return 10.0 ** rng.uniform(-8, 14, (N, M))


@pytest.mark.parametrize("name", sorted(MEL_BANKS))
def test_mel_schedule_covers_every_term_once(name):
    """``fladder.mel_schedule`` read as the kernel reads it: every nonzero
    (filter, bin) term once with its weight, L = ceil(terms / 32) steps a
    lane, padding entries 0 (weight 0 on bin 0, no store), each lane's run
    over consecutive filters and ending at a store, the slots disjoint, on
    8-byte words in the second half of the warp's row (2 x nfft/2 doubles),
    past the power, and each filter's gather range its segments' slots in
    bin order."""
    cfg = MEL_BANKS[name]
    mel = _mel_bank(cfg)
    M, nf = mel.shape
    words = fladder.mel_schedule(mel)
    ent, gather = _decode_mel(words, nf)
    terms = int((mel != 0).sum())
    assert len(ent) == -(-terms // 32) == fladder.schedule_of(
        torch.from_numpy(mel))[1]
    owner = {}                                  # slot byte -> filter
    for j, g in enumerate(gather.tolist()):
        for q in range(g >> 16):
            at = (g & 0xFFFF) + 8 * q
            assert at not in owner
            owner[at] = j
    base = 8 * M
    assert all(base <= at < 16 * M and at % 8 == 0 for at in owner)
    seen, bins_of = [], {}
    for lane in range(32):
        pending, filters = [], []
        for e in ent[:, lane]:
            w, k, at = float(e["w"]), int(e["k"]), int(e["s"])
            if w == 0.0:
                assert k == 0 and at == 0
                continue
            assert k % 8 == 0 and k < 8 * M
            pending.append((k // 8, w))
            if at:
                j = owner[at]
                filters.append(j)
                bins_of[at] = [b for b, _ in pending]
                seen += [(j, b, w_) for b, w_ in pending]
                pending = []
        assert not pending, lane
        assert filters == list(range(filters[0], filters[0] + len(filters))) \
            if filters else True
    want = sorted((int(j), int(k), float(mel[k, j]))
                  for k, j in zip(*np.nonzero(mel)))
    assert sorted(seen) == want and len(seen) == len(set(seen))
    for j, g in enumerate(gather.tolist()):
        bins = [b for q in range(g >> 16)
                for b in bins_of[(g & 0xFFFF) + 8 * q]]
        assert bins == sorted(bins) == list(np.flatnonzero(mel[:, j]))


@pytest.mark.parametrize("name", sorted(MEL_BANKS))
def test_mel_schedule_sums_are_the_lane_per_filter_sums(name):
    """On power rows from ~1e-8 to 1e14, the schedule's float64 sums (each
    segment from 0, then gathered) equal the lane-per-filter sums bit for
    bit for every filter inside one segment and within 1e-14 relative for
    a split one; ``warp_tails.float_mel_balanced`` (the kernel's index
    formulas) gives the same bits.  A difference of running sums would
    lose a quiet filter behind a loud one."""
    cfg = MEL_BANKS[name]
    mel = _mel_bank(cfg)
    M, nf = mel.shape
    words = fladder.mel_schedule(mel)
    power = _wide_power(64, M, seed=M + nf)
    got = _schedule_sums(power, words, nf)
    want = _lane_sums(power, mel)
    one = (_decode_mel(words, nf)[1] >> 16) == 1
    assert 0 < one.sum() and (~one).sum() > 0
    assert np.array_equal(got[:, one], want[:, one])
    assert np.all(np.abs(got - want) <= 1e-14 * want)
    model = wt.float_mel_balanced(torch.from_numpy(power), words, nf)
    assert np.array_equal(model.numpy(), got)


def test_mel_schedule_capacity_keeps_the_fallback():
    """A bank over the table (every filter on every bin: 32 x 256 terms,
    256 steps a lane against the table's nfft/32 = 16) has no schedule and
    its operators take the lane-per-filter loop (a null table, 0 steps); a
    bank whose segments overflow the row's second half has none either;
    the densest triangular bank, two terms a bin, fits, and so do 128
    filters at nfft 512.  The predicate and its constant are the kernels'
    (fladder_stages.cuh)."""
    cpu = torch.device("cpu")
    full = np.full((256, 32), 1.0 / 256)
    assert fladder.mel_schedule(full) is None
    assert not fladder.mel_steps_fit(256, 256)
    ops = fladder.default_operators(MFCCConfig(), cpu)
    wide = ops._replace(mel=torch.from_numpy(full))
    assert fladder.tail_tables(wide, MFCCConfig(), cpu)[-2:] == (None, 0)
    sched, steps = fladder.schedule_of(ops.mel)
    assert steps == 14 and fladder.tail_tables(ops, MFCCConfig(), cpu)[
        -2:] == (sched.data_ptr(), 14)
    assert fladder.mel_steps_fit(16, 256) and not fladder.mel_steps_fit(
        17, 256) and not fladder.mel_steps_fit(0, 256)
    over = np.zeros((128, 128))   # 255 terms, 8 steps; every lane's run
    over[0, 0] = 1.0              # splits a filter: 128 + 31 slots past
    for j in range(1, 128):       # the 128 doubles of power
        over[j - 1:j + 1, j] = 1.0
    assert fladder.mel_schedule(over) is None
    two = np.zeros((256, 32))
    for k in range(256):                   # every bin in two filters
        two[k, (k // 8) % 32] = two[k, (k // 8 + 1) % 32] = 1.0
    assert fladder.schedule_of(torch.from_numpy(two))[1] == 16
    cfg128 = MFCCConfig(nfilters=128, nceptrums=32)
    assert fladder.schedule_of(torch.from_numpy(_mel_bank(cfg128)))[1] > 0
    head = (Path(wt.__file__).resolve().parent.parent / "csrc"
            / "fladder_stages.cuh").read_text()
    assert (f"constexpr int kMelBinsPerStep = {fladder.MEL_BINS_PER_STEP};"
            in head)
    assert ("msched && msteps >= 1 && msteps <= nfft / 2 / kMelBinsPerStep"
            in head)
    assert "constexpr int kLanes = 32;" in head and fladder.MEL_LANES == 32


def test_schedule_follows_the_bank():
    """``fladder.schedule_of`` builds the schedule from the bank the
    kernels are given: once for a bank however many views of it are taken
    (the module's ``mel[:nfft/2]``), again after an in-place edit of it,
    and of its own for a swapped bank; an inference tensor's is built at
    every call.  Each equals ``mel_schedule`` of the bank as it is."""
    fe = MFCC(device="cpu")
    first, steps = fladder.schedule_of(fe._ladder_ops().mel)
    assert steps == 14
    assert fladder.schedule_of(fe._ladder_ops().mel)[0] is first
    fe.mel.mul_(0.25)
    edited = fladder.schedule_of(fe._ladder_ops().mel)[0]
    assert edited is not first and np.array_equal(
        edited.numpy(), fladder.mel_schedule(fe.mel[:256].numpy()))
    assert not np.array_equal(edited.numpy(), first.numpy())
    ops = fe._ladder_ops()
    bank = torch.roll(ops.mel, 3, 0) * 1.5
    swapped = fladder.tail_tables(ops._replace(mel=bank), fe.cfg,
                                  torch.device("cpu"))
    mine = fladder.schedule_of(bank)[0]
    assert swapped[-2:] == (mine.data_ptr(), 14) and np.array_equal(
        mine.numpy(), fladder.mel_schedule(bank.numpy()))
    with torch.inference_mode():
        frozen = fe.mel[:256].clone()
        once = fladder.schedule_of(frozen)[0]
        frozen.mul_(2.0)
        again = fladder.schedule_of(frozen)[0]
    assert again is not once and np.array_equal(
        again.numpy(), fladder.mel_schedule(frozen.numpy()))


@pytest.mark.parametrize("name", ["kaldi16k", "kaldi8k", "fpga16"])
def test_balanced_tail_model_matches_plain(name):
    """The tail's model on the schedule (the balanced mel and, at Kaldi's
    40 cepstra, the DCT's remainder on lane groups) within KERNEL_TOL of
    ``ladder_tail_plain`` and of the lane-per-filter model, for Kaldi's
    recipe and 16 filters."""
    cfg = MEL_BANKS[name]
    cpu = torch.device("cpu")
    ops = fladder.default_operators(cfg, cpu)
    frames = torch.round(_unit_frames(cfg.nfft, seed=cfg.nfft + 7) * 30000)
    floor = tables.FLT_EPSILON if cfg.recipe == "kaldi" else 0.0
    got = wt.float_tail_model(frames, ops, cfg, mel_floor=floor)
    want = fladder.ladder_tail_plain(frames, ops, cfg, floor)
    lanes = wt.float_tail_model(frames, ops, cfg, mel_floor=floor,
                                balanced=False)
    assert got.shape == want.shape == (len(frames), cfg.nceptrums)
    assert float((got - want).abs().max()) <= KERNEL_TOL
    assert float((got - lanes).abs().max()) <= KERNEL_TOL


@pytest.mark.parametrize("ncep,nf", [(40, 40), (45, 45), (33, 40), (64, 64),
                                     (32, 32), (13, 23)])
def test_dct_model_groups_the_remainder(ncep, nf):
    """The DCT's model equals the product within float64 rounding, and at
    ncep <= 32 or a multiple of 32 it is a lane a cepstrum over every
    filter (the products' own order)."""
    rng = np.random.default_rng(ncep * nf)
    lm = torch.from_numpy(rng.normal(size=(5, nf)) * 20)
    dct = torch.from_numpy(rng.normal(size=(nf, ncep)))
    got = wt.float_dct_model(lm, dct)
    want = (lm @ dct).to(torch.float32)
    assert float((got - want).abs().max()) <= 1e-5
    if ncep <= 32 or ncep % 32 == 0:
        assert torch.equal(got, want)


# -- the balanced filterbank (K3, K10's epilogue) ------------------------------

FB_CONFIGS = dict(INT_CONFIGS, hop160=(MFCCConfig(step=160),
                                       mfcc_tpu.MFCCConfig(step=160)))


def _decode_schedule(fbs):
    """The (filter, bin, weight) terms of a schedule as the kernel runs
    them: lane l's entries i*32 + l in step order, each term owned by the
    segment whose slot its lane stores to next, each slot by the filter
    whose gather range holds it.  Also each lane's (filters, real
    entries), the padding entries and the slot owners."""
    words = fbs.numpy().view(np.uint32).astype(np.int64)
    ent = words[: FB_STEPS * 32 * 2].reshape(FB_STEPS, 32, 2)
    gather = words[FB_STEPS * 32 * 2:]
    owner = {}
    for j, g in enumerate(gather):
        for k in range((int(g) >> 16) & 0x7FFF):
            assert (int(g) & 0xFFFF) + 8 * k not in owner
            owner[(int(g) & 0xFFFF) + 8 * k] = j
    terms, lanes, pads = [], [], []
    for lane in range(32):
        pending, filters, n = [], [], 0
        for i in range(FB_STEPS):
            w, offs = (int(v) for v in ent[i, lane])
            off, slot = offs & 0xFFFF, offs >> 16
            assert off % 4 == 0 and off < 4 * 256
            if w == 0:
                pads.append(offs)
                continue
            n += 1
            pending.append((off, w))
            if slot:
                j = owner[slot]
                filters.append(j)
                terms += [(j, o // 4, w_) for o, w_ in pending]
                pending = []
        assert not pending, lane       # every run ends at a segment's slot
        lanes.append((filters, n))
    return terms, lanes, pads, owner


@pytest.mark.parametrize("name", sorted(FB_CONFIGS))
def test_fb_schedule_covers_every_term_once(name):
    """The balanced schedule (``int_fused.fb_schedule``) read as the kernel
    reads it holds every nonzero (filter, bin) term of the filterbank
    exactly once with its weight; padding entries are 0 (weight 0, no
    store); no lane holds more than ceil(terms / 32) + 2 terms (at most 16
    at 16 and 32 filters); a lane's run covers consecutive filters; every
    slot lies past the power in the warp's row and belongs to one
    filter."""
    cfg = FB_CONFIGS[name][0]
    ops = int_fused.int_operators(cfg, torch.device("cpu"))
    W = ops.fbw.numpy()
    terms, lanes, pads, owner = _decode_schedule(ops.fbs)
    want = sorted((int(j), int(k), int(W[k, j]))
                  for k, j in zip(*np.nonzero(W)))
    assert sorted(terms) == want and len(terms) == len(set(terms))
    bound = -(-len(want) // 32) + 2
    assert max(n for _, n in lanes) <= bound <= FB_STEPS
    assert all(offs == 0 for offs in pads)
    for filters, _ in lanes:
        assert filters == list(range(filters[0], filters[0] + len(filters))) \
            if filters else True
    assert all(int_fused.FB_SLOT_BASE <= off and off % 8 == 0
               and off + 8 <= int_fused.FB_ROW_BYTES for off in owner)
    assert sorted(set(owner.values())) == list(range(cfg.nfilters))


def test_fb_schedule_constants_match_header():
    """The schedule's layout constants are the header's: kFbSteps entries a
    lane, slots from kSlotBase = 4 * 256 (past the power words), rows of
    kRow = 544 words, a multiple of 16 bytes (the epilogue stores its rows
    in 16-byte words)."""
    head = (Path(wt.__file__).resolve().parent.parent / "csrc"
            / "int_stages.cuh").read_text()
    assert f"constexpr int kFbSteps = {FB_STEPS};" in head
    assert "constexpr int kSlotBase = kNbins * 4;" in head
    assert "constexpr int kRow = kNfft + kNfft / 16;" in head
    assert int_fused.FB_SLOT_BASE == 4 * wt.INT_NFFT // 2
    assert int_fused.FB_ROW_BYTES == 4 * wt.INT_ROW == 4 * 544
    assert int_fused.FB_ROW_BYTES % 16 == 0


@pytest.mark.parametrize("name", sorted(INT_CONFIGS))
def test_balanced_schedule_equals_chain_and_jax(name):
    """K3's tail on the balanced filterbank (``int_tail_model(...,
    balanced=True)``) equals the lane-per-filter schedule, the ``int_ops``
    chain and JAX ``MFCC().int_frames`` element for element, on tonal,
    full-range int16 and out-of-range int32 frames."""
    cfg, jcfg = INT_CONFIGS[name]
    rng = np.random.default_rng(17)
    t = np.arange(3 * 512) / 16000.0
    tone = np.round(12000 * np.sin(2 * np.pi * (300 + 2500 * t) * t))
    frames = np.concatenate([
        tone.reshape(3, 512),
        rng.integers(-32768, 32768, (3, 512)),
        rng.integers(-2 ** 31, 2 ** 31, (2, 512)),
    ]).astype(np.int32)
    x = torch.from_numpy(frames)
    got = wt.int_tail_model(x, cfg, balanced=True)
    assert torch.equal(got, wt.int_tail_model(x, cfg))
    assert torch.equal(got, int_ops.mfcc_int_frames(x, cfg))
    with jax.default_device(jax.devices("cpu")[0]):
        want = np.asarray(mfcc_tpu.MFCC(jcfg).int_frames(frames))
    assert np.array_equal(got.numpy(), want)


EPI_ROWS = [1, 5, 7, 9, 23, 1700]


@pytest.mark.parametrize("M", EPI_ROWS)
@pytest.mark.parametrize("sms,per_sm", [(2, 1), (132, 4)])
def test_epilogue_walk_is_the_persistent_walk(M, sms, per_sm):
    """K10's epilogue's loop with its prefetch (``epilogue_walk``: the row
    a warp runs is the row it loaded one iteration before) runs every row
    once, in the rows and order of ``persistent_walk`` (F = M), on ragged
    row counts: M = 1, M < 8, M not a multiple of 8, and M far beyond the
    resident warps."""
    tiles = -(-M // wt.FRAMES_PER_BLOCK)
    for grid in (wt.persistent_grid(tiles, sms, per_sm), tiles + 2):
        got = wt.epilogue_walk(M, grid)
        want = [(b, w, G) for b, w, G, *_ in wt.persistent_walk(M, M, grid)]
        assert got == want


def test_epilogue_loop_is_the_kernels():
    """``epilogue_walk`` is the kernel's loop: int_split2.cu's
    ``int_epi_kernel`` starts at blockIdx.x * kFrames + the warp, steps by
    gridDim.x * kFrames, loads its first row before the loop and the next
    inside it, and launches through ``launch_persistent``."""
    text = (Path(wt.__file__).resolve().parent.parent / "csrc"
            / "int_split2.cu").read_text()
    body = text[text.index("int_epi_kernel("):]
    for line in (
            "const long long step = static_cast<long long>(gridDim.x) * "
            "kFrames;",
            "long long m = static_cast<long long>(blockIdx.x) * kFrames + "
            "threadIdx.x / kLanes;",
            "if (m < M) load_row(power, m, v);",
            "for (; m < M; m += step) {",
            "if (m + step < M) load_row(power, m + step, v);",
            "launch_persistent(int_epi_kernel,"):
        assert line in body, line


def test_k3_ingest_folds_first_sample():
    """K3's ingest reads first_sample(r) = bitrev(16l + r, 9) as a lane
    base bitrev(l, 5) plus the constant 32 * rev4(r), the same addresses;
    the kernel's source holds that form."""
    lane, r = torch.arange(32)[:, None], torch.arange(16)[None, :]
    rev4 = ((r & 1) << 3) | ((r & 2) << 1) | ((r & 4) >> 1) | ((r & 8) >> 3)
    assert torch.equal(wt.int_first_sample(), wt._bitrev(lane.expand(32, 1),
                                                           5) + 32 * rev4)
    text = (Path(wt.__file__).resolve().parent.parent / "csrc"
            / "int_mfcc.cu").read_text()
    body = text[text.index("int_frames_kernel("):]
    assert "const int b = bitrev(lane(), 5);" in body
    assert "re[r] = window(x[q], cv[b + q]);" in body


def test_k2_runs_the_balanced_tail():
    """K2's kernel (``int_audio_kernel``, also K9's and K3-v1's) loads the
    balanced filterbank's tables and runs ``tail_balanced`` behind its own
    ingest, ``load_audio_frame``, which reads first_sample(r) as K3 does
    (a lane base and constant offsets) and the window curve from shared
    memory; no kernel of int_mfcc.cu calls the lane-per-filter ``tail(``,
    and int_stages.cuh no longer defines it."""
    csrc = Path(wt.__file__).resolve().parent.parent / "csrc"
    text = (csrc / "int_mfcc.cu").read_text()
    body = text[text.index("int_audio_kernel("):text.index("int_frames_kernel(")]
    for line in ("__shared__ FbLadderSmem sm;",
                 "load_fb_tables(sm.fb, sched, c);",
                 "sm.curve[i] = curve[i];",
                 "const volatile int* cv = sm.curve;",
                 "load_audio_frame(audio + s * T",
                 "tail_balanced(re, sm, c, out + G * c.ncep);"):
        assert line in body, line
    assert not re.search(r"(?<![\w.])tail\(", text)
    assert text.count("tail_balanced(re, sm, c,") == 2       # K2 and K3
    head = (csrc / "int_stages.cuh").read_text()
    ingest = head[head.index("void load_audio_frame("):]
    ingest = ingest[:ingest.index("\n}\n")]
    for line in ("const int b = bitrev(lane(), 5);",
                 "const int q = 32 * rev4(r);",
                 "re[r] = window(emphasize<In>(x[q], prev), curve[q]);"):
        assert line in ingest, line
    for gone in ("void tail(", "void post_power(", "load_tail_tables",
                 "kFbTable", "fbt["):
        assert gone not in head, gone


# -- the serving step's persistent walk (stream_step.cu) ----------------------

STEP_P = 511    # P = nfft - 1: the carry positions of a stream


@pytest.mark.parametrize("F", [1, 2, 7, 13])
@pytest.mark.parametrize("S", [1, 3, 130, 4096])
def test_step_walk_writes_every_output_once(S, F):
    """K4's persistent kernels (``warp_tails.step_walk``, the kernels' loop
    bounds and index formulas) write every (stream, frame slot)'s features
    and mask entry, every carry position of every stream, and every
    stream's new count and prev exactly once, on the staged window and on
    the per-point kernels alike; each warp takes its slots in ascending
    order, and an 8-slot tile spans stream boundaries where F is not a
    multiple of 8 (no warp idles while slots are left).  On the staged
    window a stream's carry, count and prev are written by the block whose
    tile holds its slot 0 (the carry by all 256 threads, position p by
    thread p mod 256; count and prev by thread s - s0, s0 the tile's first
    stream).  For the grid the occupancy gives at 3 blocks an SM, a
    grid of 2 blocks, and a grid larger than the tile count (idle
    blocks)."""
    M = S * F
    tiles = -(-M // wt.FRAMES_PER_BLOCK)
    for staged in (True, False):
        for grid in (wt.persistent_grid(tiles, 132, 3), 2, tiles + 3):
            walk = wt.step_walk(S, F, grid, STEP_P, staged=staged)
            for name, n in (("feats", M), ("mask", M),
                            ("carry", S * STEP_P), ("count", S),
                            ("prev", S)):
                idx = walk[name]
                assert idx.min(initial=0) >= 0 and idx.max(initial=0) < n, name
                assert (np.bincount(idx, minlength=n) == 1).all(), (name, grid)
            b, w = walk["warp"][:, 0], walk["warp"][:, 1]
            assert (b < grid).all() and (w < wt.FRAMES_PER_BLOCK).all()
            per_warp = {}
            for key, G in zip(b * wt.FRAMES_PER_BLOCK + w, walk["feats"]):
                per_warp.setdefault(int(key), []).append(int(G))
            for seq in per_warp.values():
                assert seq == sorted(seq)
                assert seq[0] < grid * wt.FRAMES_PER_BLOCK
            busy = min(M, grid * wt.FRAMES_PER_BLOCK)
            assert len(per_warp) == busy           # no warp idles early
            assert sorted(walk["feats"].tolist()) == list(range(M))
            cb, sb = walk["carry_by"], walk["state_by"]
            assert len(cb) == S * STEP_P and len(sb) == S
            assert (cb[:, 0] < grid).all() and (cb[:, 1] < 256).all()
            # the block that writes a stream's carry, count and prev holds
            # its slot 0
            home = (walk["count"] * F // wt.FRAMES_PER_BLOCK) % grid
            assert (sb[:, 0] == home).all()
            if staged:
                assert (cb[:, 0] == np.repeat(home, STEP_P)).all()
                assert (cb[:, 1] == walk["carry"] % STEP_P % 256).all()
                s0 = (walk["count"] * F // wt.FRAMES_PER_BLOCK
                      * wt.FRAMES_PER_BLOCK) // F
                assert (sb[:, 1] == walk["count"] - s0).all()
                assert (sb[:, 1] < wt.FRAMES_PER_BLOCK).all()
            else:
                assert (sb[:, 1] % 32 == 0).all()   # lane 0 of slot 0's warp
    # the model against the persistent walk of the batch kernels
    grid = wt.persistent_grid(tiles, 132, 3)
    walk = wt.step_walk(S, F, grid, STEP_P)
    want = [(b, w, G) for b, w, G, *_ in wt.persistent_walk(M, F, grid)]
    got = sorted(zip(walk["warp"][:, 0].tolist(), walk["warp"][:, 1].tolist(),
                     walk["feats"].tolist()))
    assert got == sorted(want)


@pytest.mark.parametrize("kernel", ["K4-float", "K4-INT"])
def test_step_walk_span_test_picks_the_path(kernel):
    """``stream_fused.staged`` (the kernels' test) takes the staged window
    where the carry and the chunk are the (S, P) carry and (S, C) chunk,
    rows back to back, and the rows of a tile's streams (``tile_streams``
    of them) fit the kernel's row buffer (``rows_bytes``): the serving
    width (C = 1024 int16, F = 7, two streams a tile, 8,336 bytes) on both
    kernels; the float kernel's smaller buffer leaves its widest and
    narrowest int16 widths and its f32 chunks to the per-point kernels, the
    INT kernel's only int32 widths over 2,214.  Either path writes every
    output once (``step_walk``), and a carry or chunk of other strides
    takes the per-point kernels at any width."""
    from mfcc_tpu_torch.ops import stream_fused as sf
    assert sf.tile_streams(7) == 2 and sf.tile_streams(1) == 8
    assert sf.tile_streams(13) == 2 and sf.tile_streams(2) == 5
    assert sf.rows_bytes(2, STEP_P, 1024, 2) == 8336
    want = {("K4-float", 2): {600, 1024, 1360, 1530},
            ("K4-float", 4): set(),
            ("K4-INT", 2): {1, 169, 170, 171, 600, 1024, 1360, 1530, 2048},
            ("K4-INT", 4): {1, 169, 170, 171, 600, 1024, 1360, 1530, 2048}}
    for b in (2, 4):
        got = set()
        for C in (1, 169, 170, 171, 600, 1024, 1360, 1530, 2048):
            F = (C - 1) // 170 + 1
            if sf.staged(kernel, F, C, 512, b, (STEP_P, 1, C, 1)):
                got.add(C)
            for st in ((1, 130, C, 1), (STEP_P, 1, 1, 130),
                       (STEP_P + 1, 1, C, 1), (STEP_P, 1, C + 2, 1)):
                assert not sf.staged(kernel, F, C, 512, b, st)
            for S in (1, 3, 130):
                walk = wt.step_walk(S, F, 2, STEP_P, staged=C in got)
                for name, n in (("feats", S * F), ("carry", S * STEP_P),
                                ("count", S)):
                    assert (np.bincount(walk[name], minlength=n) == 1).all()
        assert got == want[kernel, b], (kernel, b, sorted(got))
    assert not sf.staged("K4-INT", 14, 2215, 512, 4, (STEP_P, 1, 2215, 1))
    assert sf.staged("K4-INT", 14, 2214, 512, 4, (STEP_P, 1, 2214, 1))


@pytest.mark.parametrize("C", [1, 169, 170, 171, 600, 1024, 1360, 2048])
@pytest.mark.parametrize("in_bytes", [2, 4])
def test_step_rows_hold_each_frame(C, in_bytes):
    """The staged kernels' row copies (``warp_tails.step_rows``: a tile's
    chunk rows as one run of aligned 16-byte blocks, from the block holding
    its first sample) give back every sample of every stream at byte m +
    (i*C + t) * in_bytes, the blocks stay within the run's first and last
    blocks, and the copy fits ``rows_bytes``; each frame read from the rows
    (``step_e``; a frame
    wholly inside the chunk at a base and constant offsets, t0 >= 1 and t0
    + nfft <= C) is E[q0 : q0 + nfft] of the stream, for counts 0, P,
    random and out of [0, P]."""
    from mfcc_tpu_torch.ops import stream_fused as sf
    P, nfft, hop, S = STEP_P, 512, 170, 5
    F = (C - 1) // hop + 1
    rng = np.random.default_rng(C * in_bytes)
    dt = np.int16 if in_bytes == 2 else np.int32
    emph = lambda x, p: int(x) * 32 - int(p)      # any function of (x, p)
    for pad in ((0, 2, 6, 14) if in_bytes == 2 else (0, 4, 12)):
        mem = np.zeros(16 + S * C * in_bytes + 32, np.uint8)
        x = rng.integers(-30000, 30000, (S, C)).astype(dt)
        base = 16 + pad
        mem[base:base + x.nbytes] = np.frombuffer(x.tobytes(), np.uint8)
        carry = rng.integers(-9, 9, (S, P))
        prev = rng.integers(-9, 9, S)
        for s0, ns, xa, nw, m in wt.step_rows(S, F, C, in_bytes, base):
            xb = base + s0 * C * in_bytes
            assert xa <= xb < xa + 16 and xa % 16 == 0
            assert xa + 16 * nw - (xb + ns * C * in_bytes) < 16
            assert ns <= sf.tile_streams(F)
            carry_blocks = (12 + 4 * P * ns + 15) // 16   # its worst offset
            assert (sf._align16(16 * carry_blocks) + 16 * nw + 8 * 8 + 16
                    <= sf.rows_bytes(sf.tile_streams(F), P, C, in_bytes))
            words = mem[xa:xa + 16 * nw]
            for i in range(ns):
                s = s0 + i
                lo = m + i * C * in_bytes
                row = np.frombuffer(words[lo:lo + C * in_bytes].tobytes(), dt)
                assert np.array_equal(row, x[s]), (s, pad)
                for count in (0, P, int(rng.integers(0, P + 1)), -3000, 3000):
                    for g in range(F):
                        q0 = int(np.clip(P - count + g * hop, -1024, P + C))
                        want = [wt.step_e(carry[s], x[s], prev[s], q, P, C,
                                          emph)
                                for q in range(q0, q0 + nfft)]
                        t0 = q0 - P
                        if t0 >= 1 and t0 + nfft <= C:       # the fast path
                            got = [emph(row[t0 + j], row[t0 + j - 1])
                                   for j in range(nfft)]
                            assert got == want, (s, count, g)


def test_step_walk_is_the_kernels():
    """``step_walk`` and ``step_rows`` hold the kernels' formulas: the
    staged kernels (``stream_f32_kernel``, ``stream_int_kernel``) walk
    tiles t from blockIdx.x by gridDim.x over ceil(M / 8) tiles through
    ``staged_walk``: one barrier a tile after the tile's copies are waited
    for, the next tile's copies issued into the other row buffer, the new
    carry of a stream whose slot 0 is in the tile (position p by thread p
    mod 256) and its count and prev (thread i), warp w on slot t * 8 + w;
    ``rows_issue`` copies the tile's carry rows and chunk rows as two runs
    of aligned 16-byte blocks from the block holding each run's first
    value, ``rows_of`` reads stream i's row at the run's byte offset mod 16
    plus i rows.  The per-point kernels walk G from blockIdx.x * kFrames + the warp
    by gridDim.x * kFrames over M = S*F slots in 32-bit indices (the
    launches refuse M >= 2^30) with (s, g) = (G / F, G - s*F), and write
    through ``step_outputs``: carry positions [g * share, min(P, (g + 1) *
    share)) with share = ceil(P / F), mask[G], and on slot 0 the count and
    prev; the valid count is an explicit floor division; each launch takes
    the staged kernel where ``staged`` holds."""
    text = (Path(wt.__file__).resolve().parent.parent / "csrc"
            / "stream_step.cu").read_text()
    heads = re.findall(
        r"for \(int G = static_cast<int>\(blockIdx\.x\) \* kFrames \+ "
        r"threadIdx\.x / kLanes;\s*G < M; G \+= "
        r"static_cast<int>\(gridDim\.x\) \* kFrames\)", text)
    assert len(heads) == 2, heads
    for kernel in ("stream_f32_pointwise_kernel",
                   "stream_int_pointwise_kernel"):
        body = text[text.index(kernel + "("):]
        body = body[:body.index("\n}\n")]
        assert "const int s = G / F;" in body
        assert "const int g = G - s * F;" in body
        assert "step_outputs(io, ncarry, xs, s, G, g, count," in body
    for kernel in ("stream_f32_kernel", "stream_int_kernel"):
        body = text[text.index(kernel + "("):]
        body = body[:body.index("\n}\n")]
        assert "staged_walk(" in body and "unit_positions(st)," in body
    assert text.count("if (S * F >= (1LL << 30)) return") == 2
    for line in ("const int share = (P + F - 1) / F;",
                 "const int p1 = min(P, (g + 1) * share);",
                 "for (int p = g * share + (threadIdx.x & 31); p < p1; "
                 "p += 32)",
                 "const int n_valid = max(floor_div(total - (P + 1), hop) "
                 "+ 1, 0);",
                 "io.mask[G] = g < n_valid;",
                 "if (g == 0) {",
                 "return q - (q * b > a ? 1 : 0);",
                 # the staged walk
                 "constexpr int kSlots = 8;",
                 "const int tiles = (M + kSlots - 1) / kSlots;",
                 "for (int t = blockIdx.x; t < tiles; t += gridDim.x, "
                 "par ^= 1) {",
                 'asm volatile("cp.async.wait_all;\\n" ::: "memory");',
                 "rows_issue(rows + (par ^ 1) * buffer, lay, Tile(tn, M, F), "
                 "carry,",
                 ": G0(t * kSlots), G1(min(t * kSlots + kSlots, M)), "
                 "s0(G0 / F_),",
                 "ns((G1 - 1) / F_ - G0 / F_ + 1), F(F_) {}",
                 "return max(G0 - (s0 + i) * F, 0);",
                 "if (tl.ga(i) != 0) continue;   // slot 0 is in an earlier "
                 "tile",
                 "if (threadIdx.x == i) {",
                 "for (int p = threadIdx.x; p < P; p += kSlots * 32)",
                 "const int G = tl.G0 + static_cast<int>(threadIdx.x) / 32;",
                 "io.mask[G] = g < valid_frames(w.count, P, C, hop);",
                 "slot(G, w, frame_start(P, w.count, g, hop, C));",
                 "return max(floor_div(count + C - (P + 1), hop) + 1, 0);",
                 "run_issue(buf, carry + static_cast<long long>(tl.s0) * P,",
                 "run_issue(buf + lay.chunk, chunk + static_cast<long long>"
                 "(tl.s0) * C,",
                 "for (int k = threadIdx.x; k < n; k += kSlots * 32)",
                 "cp_async16(dst + 16 * k, a + 16 * k);",
                 "buf + byte_in_block<16>(carry + static_cast<long long>"
                 "(tl.s0) * P)) +",
                 "byte_in_block<16>(chunk + static_cast<long long>(tl.s0) * "
                 "C)) +",
                 "const long long c = align16(4LL * P * n + 31);",
                 "const long long x = align16(static_cast<long long>"
                 "(in_bytes) * C * n + 31);",
                 "constexpr int kStateBytes = 8 * kSlots + 16;",
                 "const int n = (kSlots - 2 + F) / F + 1;",
                 "return st.carry_p == 1 && st.chunk_t == 1 && st.carry_s "
                 "== P &&",
                 "constexpr int kRowsF32 = 11776;",
                 "constexpr int kRowsInt = 21952;",
                 "return static_cast<int>(q0 < -1024 ? -1024 : q0 > P + C ? "
                 "P + C : q0);"):
        assert line in text, line
    assert text.count("launch_persistent(\n      window ? stream_") == 2
    assert ("window ? stream_int_kernel<In> : "
            "stream_int_pointwise_kernel<In>") in text
    assert ("window ? stream_f32_kernel<In> : "
            "stream_f32_pointwise_kernel<In>") in text
    assert "const bool window = staged(F, P, C, sizeof(In), kRowsF32, st);" in text
    assert "const bool window = staged(F, P, C, sizeof(In), kRowsInt, st);" in text
    assert ("tail_balanced(re, sm, c, out + static_cast<long long>(G) * "
            "c.ncep);") in text
    from mfcc_tpu_torch.ops import stream_fused as sf
    assert sf.ROWS_BYTES == {"K4-float": 11776, "K4-INT": 21952}
    assert sf.TILE_SLOTS == 8


def test_step_floor_div_model():
    """The kernel's floor division (``floor_div``: truncating division less
    one where the quotient times the divisor passes the dividend) is
    floor division at the hops of the family, where C++'s truncating /
    alone gives one frame too many for a dividend in (-hop, 0)."""
    for b in (160, 170, 2):
        for a in range(-1100, 1101):
            q = int(a / b)                  # C++ truncates toward zero
            q -= 1 if q * b > a else 0
            assert q == a // b, (a, b)
