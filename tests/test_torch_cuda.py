"""The torch package's CUDA kernels on the card: K1 (float) against its
plain version within TOL, K2 and K3 (INT) against theirs element for
element (``torch.equal``), the serving step K4 (float within TOL, INT and
every carry ``torch.equal``; its staged window bit for bit against its
per-point kernels, and the launches each takes), K5, K5-frames and the
split-DFT step (within
TOL_R2), K6, K7 and K7-frames (within TOL; K7 on int16 equal to K1, on
ragged shapes and at the headline size), K8's seven dense-DFT entries
(within TOL), K9, K3-v1 and K10 (``torch.equal``; K3-v1 on int32 edges
and int64 too, one launch and no allocation but its output), K3 and K10's
persistent epilogue on the balanced filterbank (ragged row counts, leading
axes, 16 and 32 filters), K2, K9 and K3-v1 on the same filterbank (ragged
and one-frame shapes, leading axes, 16 and 32 filters), streaming
against batch, the split chain and the ``FeatureServer`` on the card; and the
warp tails' geometry (one warp a frame, 8 frames a block): ragged frame
counts for K1, K2, K3 and K10, and K4 where a stream's frame slots fill a
tile partly, wholly or into a second one; and the FP64 product engine of
K5 and K8: its ragged tiles, caller-given operators edited in place, and
a launch whose C entry point refuses it raising.

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one.  The file imports neither JAX nor ``mfcc_tpu``, so it runs on
a host that has only PyTorch with CUDA:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from mfcc_tpu_torch import (MFCC, MFCCConfig, MIC_CONFIG, KALDI_MFCC_HIRES,
                            FeatureServer, StreamingMFCC)
from mfcc_tpu_torch.kernels import build
from mfcc_tpu_torch.ops import (dense_fused, dmma_product, f64ish, fladder,
                                float_fused, float_ops, framing, int_fused,
                                stream_fused)
from mfcc_tpu_torch.ref import float_ref, int_ref
from mfcc_tpu_torch.server import stream_samples

# Kernel and plain version both compute in float64 and round once to f32:
# they differ by an f32 ulp at most (measured 2.4e-7 at the headline
# shape); 5e-5 is the JAX K1's own bound against the oracle.
TOL = 5e-5
GATE = 5e-4
# K5's kernel and plain version both sum exact limb products in float64 and
# round once; the f32 rest of the tail (mel, log2, DCT) differs in the
# order of its sums.  2e-4 is the JAX kernel's own distance from the port's
# plain version on the CPU tests; the fast mode's oracle gate is 2e-3.
TOL_R2 = 2e-4
FAST_GATE = 2e-3


def gate_units(got, want):
    """The f64ish metric: max |got - want| / max(1e-5, 2 ulp(want)), inf
    unless finite; <= 1.0 passes (``bench.f64ish_gate_err``)."""
    tol = np.maximum(1e-5, 2 * np.abs(want) * np.finfo(np.float32).eps)
    err = float((np.abs(got - want) / tol).max())
    return err if np.isfinite(err) else float("inf")


pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _tonal(S, T, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000.0
    base = (9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
            + 4000 * np.sin(2 * np.pi * 900 * t))
    return np.round(np.clip(base[None] + rng.integers(-1500, 1500, (S, T)),
                            -32768, 32767)).astype(np.float32)


@pytest.mark.parametrize("nfft,hop", [(256, 86), (512, 170), (1024, 340)])
def test_kernel_matches_plain(dev, nfft, hop):
    cfg = MFCCConfig(nfft=nfft, step=hop)
    sig = _tonal(8, 16000, seed=nfft)
    for x, floor in ((sig.astype(np.int16), 0.0), (sig, 0.0),
                     (sig / np.float32(32768), 0.0),
                     (np.zeros((1, 16000), np.float32), 1.0)):
        xt = torch.from_numpy(np.array(x)).to(dev)
        before = fladder.LAUNCHES
        got = fladder.mfcc_float_ladder(xt, cfg, floor)
        torch.cuda.synchronize()
        assert fladder.LAUNCHES == before + 1
        want = fladder.mfcc_float_ladder_plain(xt, cfg, floor)
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= TOL


def test_ragged_tiles_and_leading_dims(dev):
    """Frame counts that are not a multiple of the block's tile, 1-D and
    3-D inputs."""
    cfg = MFCCConfig()
    for T in (512, 512 + 170, 512 + 5 * 170 + 3, 9000):
        x = torch.from_numpy(_tonal(3, T, seed=T)).to(dev)
        got = fladder.mfcc_float_ladder(x, cfg)
        want = fladder.mfcc_float_ladder_plain(x, cfg)
        assert got.shape == (3, cfg.n_frames(T), 32)
        assert (got - want).abs().max().item() <= TOL
    x = torch.from_numpy(_tonal(4, 3000, seed=1)).to(dev)
    full = fladder.mfcc_float_ladder(x, cfg)
    assert torch.equal(fladder.mfcc_float_ladder(x[1], cfg), full[1])
    assert torch.equal(fladder.mfcc_float_ladder(x.reshape(2, 2, -1), cfg),
                       full.reshape(2, 2, *full.shape[1:]))


def test_module_route_on_card(dev):
    sig = _tonal(4, 16000, seed=3)
    fe = MFCC().to(dev)
    before = fladder.LAUNCHES
    got = fe(torch.from_numpy(sig.astype(np.int16)).to(dev))
    assert fladder.LAUNCHES == before + 1
    want = np.stack([float_ref.mfcc_float(s) for s in sig])
    assert np.abs(got.cpu().numpy() - want).max() <= GATE
    # the plain chain on the card holds the gate too (full-f32 matmuls)
    chain = float_ops.mfcc_batch(torch.from_numpy(sig).to(dev))
    assert np.abs(chain.cpu().numpy() - want).max() <= GATE


def test_loaded_operators_on_card(dev):
    """Operators loaded through state_dict reach the kernel: a mel whose
    bands span every bin changes K1's band limits."""
    mel = torch.zeros(257, 32, dtype=torch.float64)
    mel[:256] = 1.0 / 256
    state = MFCC().state_dict()
    state["mel"] = mel
    fe = MFCC().to(dev)
    fe.load_state_dict(state)
    x = torch.from_numpy(_tonal(2, 8000, seed=4)).to(dev)
    ops = fladder.LadderOperators(fe.ladder_window, fe.mel[:256], fe.dct,
                                  fe.mel_band)
    want = fladder.mfcc_float_ladder_plain(x, fe.cfg, operators=ops)
    assert (fe(x) - want).abs().max().item() <= TOL
    chain = float_ops.mfcc_batch(x.cpu(), fe.cfg)
    assert not torch.equal(fe(x).cpu(), chain)


def test_input_device_must_match_on_card(dev):
    x = torch.zeros(1, 4000)
    with pytest.raises(ValueError, match="cpu.*cuda"):
        MFCC().to(dev)(x)
    with pytest.raises(ValueError, match="cuda.*cpu"):
        MFCC(device="cpu")(x.to(dev))


def test_wrapper_checks_on_card(dev):
    x = torch.zeros(2, 4000, device=dev)
    with pytest.raises(TypeError, match="int16 or float32"):
        fladder.mfcc_float_ladder(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        fladder.mfcc_float_ladder(torch.zeros(4000, 2, device=dev).t())
    ops = fladder.default_operators(MFCCConfig(), dev)
    with pytest.raises(ValueError, match="operator window"):
        fladder.mfcc_float_ladder(x, operators=ops._replace(
            window=ops.window.float()))
    with pytest.raises(ValueError, match="operator band"):
        fladder.mfcc_float_ladder(x, operators=ops._replace(
            band=ops.band.long()))


def test_mel_schedule_on_every_tail_kernel(dev, monkeypatch):
    """Every kernel on the FP64 tail sums its mel on the balanced schedule:
    ``fladder.MEL_SCHEDULE_LAUNCHES`` counts one a launch of K1
    (``MFCC()(audio)``), K1-Kaldi (``MFCC(KALDI_MFCC_HIRES)(audio)``), K6,
    K7, K7-frames and K4-float, and none where a loaded bank exceeds the
    table or where the schedule is withheld (the lane-per-filter loop,
    here on the same banks); the loop's output is within TOL of the
    schedule's and of the plain version."""
    sig = _tonal(3, 6000, seed=21)
    x16 = torch.from_numpy(sig.astype(np.int16)).to(dev)

    def runs(fn):
        before = fladder.MEL_SCHEDULE_LAUNCHES
        out = fn()
        torch.cuda.synchronize()
        return fladder.MEL_SCHEDULE_LAUNCHES - before, out

    frames = framing.extract_frames(framing.preemphasis(
        x16.float()), 512, 170).contiguous()
    for fn in (lambda: MFCC()(x16), lambda: MFCC(KALDI_MFCC_HIRES)(x16),
               lambda: MFCC(MFCCConfig(step=171))(x16),
               lambda: MFCC(precision="f64ish")(x16),
               lambda: f64ish.mfcc_f64ish_frames(frames, MFCCConfig())):
        assert runs(fn)[0] == 1
    sm = StreamingMFCC()
    state = sm.init(3)
    assert runs(lambda: sm.step(x16[:, :1024], state))[0] == 1
    cfg = MFCCConfig()
    balanced = fladder.mfcc_float_ladder(x16, cfg)
    kbalanced = fladder.mfcc_kaldi_ladder(x16, KALDI_MFCC_HIRES)
    mel = torch.zeros(257, 32, dtype=torch.float64)
    mel[:256] = 1.0 / 256                  # 8,192 terms: over the table
    fe = MFCC().to(dev)
    state = fe.state_dict()
    state["mel"] = mel
    fe.load_state_dict(state)
    n, full = runs(lambda: fe(x16))
    assert n == 0
    want = fladder.mfcc_float_ladder_plain(x16, cfg,
                                           operators=fe._ladder_ops())
    assert (full - want).abs().max().item() <= TOL
    monkeypatch.setattr(fladder, "schedule_of", lambda mel: (None, 0))
    k1 = fladder.LAUNCHES
    n, lanes = runs(lambda: fladder.mfcc_float_ladder(x16, cfg))
    assert n == 0 and fladder.LAUNCHES == k1 + 1
    assert (lanes - balanced).abs().max().item() <= TOL
    want = fladder.mfcc_float_ladder_plain(x16, cfg)
    assert (lanes - want).abs().max().item() <= TOL
    n, klanes = runs(lambda: fladder.mfcc_kaldi_ladder(x16, KALDI_MFCC_HIRES))
    assert n == 0
    assert (klanes - kbalanced).abs().max().item() <= TOL


def test_tail_walk_instantiations_on_card(dev):
    """Each of the FP64 tail walk's seven instantiations, (ingest, input
    dtype), launched once through its entry at nfft 512: the entry's own
    counter moves by one and no other entry's does, every launch runs the
    mel schedule (``MEL_SCHEDULE_LAUNCHES`` + 1), and each output is
    within TOL of its plain version."""
    x16 = torch.from_numpy(_tonal(3, 6000, seed=22).astype(np.int16)).to(dev)
    xf = x16.float()
    frames = framing.extract_frames(framing.preemphasis(xf), 512,
                                    170).contiguous()
    kframes = framing.extract_frames(xf, 512, 160, 400).contiguous()
    cfg, odd, kaldi = MFCCConfig(), MFCCConfig(step=171), KALDI_MFCC_HIRES

    def counters():
        return {"K1": fladder.LAUNCHES, "K1-Kaldi": fladder.KALDI_LAUNCHES,
                "K6": float_fused.LAUNCHES["K6"], **f64ish.LAUNCHES}

    cases = (
        ("K1", lambda: fladder.mfcc_float_ladder(x16, cfg),
         lambda: fladder.mfcc_float_ladder_plain(x16, cfg)),
        ("K6", lambda: float_fused.mfcc_recomp_t(xf, odd),
         lambda: float_fused.mfcc_recomp_t_plain(xf, odd)),
        ("K1-Kaldi", lambda: fladder.mfcc_kaldi_ladder(x16, kaldi),
         lambda: fladder.mfcc_kaldi_ladder_plain(x16, kaldi)),
        ("K1-Kaldi", lambda: fladder.mfcc_kaldi_frames(kframes, kaldi),
         lambda: fladder.mfcc_kaldi_frames_plain(kframes, kaldi)),
        ("K7", lambda: f64ish.mfcc_f64ish(x16, cfg),
         lambda: f64ish.mfcc_batch_f64ish_plain(x16, cfg)),
        ("K7", lambda: f64ish.mfcc_f64ish(xf / 32768, cfg, wire_grid=False),
         lambda: f64ish.mfcc_batch_f64ish_plain(xf / 32768, cfg,
                                                wire_grid=False)),
        ("K7-frames", lambda: f64ish.mfcc_f64ish_frames(frames, cfg),
         lambda: f64ish.mfcc_frames_f64ish_plain(frames, cfg)))
    for key, kernel, plain in cases:
        before, sched = counters(), fladder.MEL_SCHEDULE_LAUNCHES
        got = kernel()
        torch.cuda.synchronize()
        after = counters()
        assert after == {**before, key: before[key] + 1}, key
        assert fladder.MEL_SCHEDULE_LAUNCHES == sched + 1, key
        assert (got - plain()).abs().max().item() <= TOL, key


def _k4_float_once(x16, ops, cfg):
    """One K4-float step of fresh streams over x16 with the operators
    ``ops`` and its plain version: (kernel feats, plain feats)."""
    S, C = x16.shape
    P = cfg.nfft - 1
    buf = torch.zeros(S, P, dtype=torch.float32, device=x16.device)
    start = torch.full((S,), P, dtype=torch.int32, device=x16.device)
    prev = torch.zeros(S, dtype=torch.float32, device=x16.device)
    got, _ = stream_fused.stream_step_float(buf, x16, start, prev, cfg,
                                            operators=ops)
    want, _ = stream_fused.stream_step_float_plain(buf, x16, start, prev,
                                                   cfg, operators=ops)
    return got, want


def test_tail_follows_the_bank(dev):
    """K1 and K4-float read the schedule of the bank they are given: after
    an in-place edit of the module's mel, of caller-given operators' mel,
    and with a bank swapped in by ``_replace``, each call is within TOL of
    the plain version on the bank as it is then, not on the bank a schedule
    was first built from; 128 filters at nfft 512 and 1024 run on the
    schedule too."""
    cfg = MFCCConfig()
    x16 = torch.from_numpy(_tonal(3, 6000, seed=23).astype(np.int16)).to(dev)
    fe = MFCC().to(dev)
    d = fladder.default_operators(cfg, dev)
    ops = d._replace(mel=d.mel.clone())
    for _ in range(2):
        got = fe(x16)
        want = fladder.mfcc_float_ladder_plain(x16, cfg,
                                               operators=fe._ladder_ops())
        assert (got - want).abs().max().item() <= TOL
        got = fladder.mfcc_float_ladder(x16, cfg, operators=ops)
        want = fladder.mfcc_float_ladder_plain(x16, cfg, operators=ops)
        assert (got - want).abs().max().item() <= TOL
        got, want = _k4_float_once(x16[:, :1024], ops, cfg)
        assert (got - want).abs().max().item() <= TOL
        fe.mel[:, 3].mul_(0.25)
        ops.mel[:, 5].mul_(4.0)
    assert (fe(x16) - MFCC().to(dev)(x16)).abs().max().item() > 1e-3
    bank = torch.roll(d.mel, 3, 0) * 1.5
    swapped = d._replace(mel=bank, band=fladder.mel_bands(bank))
    before = fladder.MEL_SCHEDULE_LAUNCHES
    got = fladder.mfcc_float_ladder(x16, cfg, operators=swapped)
    want = fladder.mfcc_float_ladder_plain(x16, cfg, operators=swapped)
    assert (got - want).abs().max().item() <= TOL
    got, want = _k4_float_once(x16[:, :1024], swapped, cfg)
    assert (got - want).abs().max().item() <= TOL
    torch.cuda.synchronize()
    assert fladder.MEL_SCHEDULE_LAUNCHES == before + 2
    # 13 of the 128 filters at nfft 512 hold no bin: a floor keeps them
    # finite
    for wide in (MFCCConfig(nfilters=128, nceptrums=32),
                 MFCCConfig(nfft=1024, step=340, nfilters=128,
                            nceptrums=32)):
        before = fladder.MEL_SCHEDULE_LAUNCHES
        got = fladder.mfcc_float_ladder(x16, wide, mel_floor=1.0)
        torch.cuda.synchronize()
        assert fladder.MEL_SCHEDULE_LAUNCHES == before + 1
        want = fladder.mfcc_float_ladder_plain(x16, wide, mel_floor=1.0)
        assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("passes", [3, 4, 6])
@pytest.mark.parametrize("nfft,hop", [(256, 86), (512, 170), (1024, 340)])
def test_radix2_kernel_matches_plain(dev, nfft, hop, passes):
    """K5 and K5-frames against their plain versions, int16 and f32 input,
    with and without a mel floor, ragged tiles."""
    cfg = MFCCConfig(nfft=nfft, step=hop)
    sig = _tonal(6, 9000, seed=nfft + passes)
    for x, floor in ((sig.astype(np.int16), 0.0), (sig, 0.0),
                     (np.zeros((1, 4000), np.float32), 1.0)):
        xt = torch.from_numpy(np.array(x)).to(dev)
        before = dict(float_fused.LAUNCHES)
        got = float_fused.mfcc_radix2(xt, cfg, dft_passes=passes,
                                      mel_floor=floor)
        torch.cuda.synchronize()
        assert float_fused.LAUNCHES["K5"] == before["K5"] + 1
        want = float_fused.mfcc_radix2_plain(xt, cfg, dft_passes=passes,
                                             mel_floor=floor)
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= TOL_R2
    frames = framing.extract_frames(framing.preemphasis(
        torch.from_numpy(sig).to(dev)), nfft, hop)[:, :-1].contiguous()
    got = float_fused.mfcc_frames_float(frames, cfg, dft_passes=passes)
    want = float_fused.mfcc_frames_float_plain(frames, cfg,
                                               dft_passes=passes)
    assert got.shape == frames.shape[:-1] + (32,)
    assert (got - want).abs().max().item() <= TOL_R2


@pytest.mark.parametrize("step", [171, 165, 170])
def test_recomp_t_kernel_matches_plain(dev, step):
    """K6 launches K1's kernel at any hop, with its own count."""
    cfg = MFCCConfig(step=step)
    x = torch.from_numpy(_tonal(5, 9000, seed=step)).to(dev)
    k1, k6 = fladder.LAUNCHES, float_fused.LAUNCHES["K6"]
    got = float_fused.mfcc_recomp_t(x.to(torch.int16), cfg)
    torch.cuda.synchronize()
    assert float_fused.LAUNCHES["K6"] == k6 + 1 and fladder.LAUNCHES == k1
    want = float_fused.mfcc_recomp_t_plain(x, cfg)
    assert got.shape == (5, cfg.n_frames(9000), 32)
    assert (got - want).abs().max().item() <= TOL


def test_fast_and_odd_hop_routes_on_card(dev):
    """The routes that raised before K5 and K6 were ported now launch them:
    ``MFCC(precision="fast")`` K5 at 3 passes, ``.frames`` K5-frames, an odd
    hop K6.  The fast gate (2e-3) is held on the JAX bench's gate input
    (``bench.accuracy_of``: 2 streams x 5 frames), where the JAX kernel
    holds it; on long tonal input the 3-pass limb split itself reads ~1e-2
    (PERF.md)."""
    sig = _tonal(2, 512 + 4 * 170, seed=7)
    x = torch.from_numpy(sig.astype(np.int16)).to(dev)
    before = dict(float_fused.LAUNCHES)
    fast = MFCC(precision="fast")(x)
    odd = MFCC(MFCCConfig(step=171))(x)
    frames = framing.extract_frames(framing.preemphasis(
        torch.from_numpy(sig).to(dev)), 512, 170)
    fast_frames = MFCC(precision="fast").frames(frames)
    torch.cuda.synchronize()
    assert {k: float_fused.LAUNCHES[k] - before[k]
            for k in before} == {"K5": 1, "K5-frames": 1, "K6": 1}
    want = np.stack([float_ref.mfcc_float(s) for s in sig])
    assert np.abs(fast.cpu().numpy() - want).max() <= FAST_GATE
    assert np.abs(fast_frames.cpu().numpy() - want).max() <= FAST_GATE
    assert (fast_frames - fast).abs().max().item() <= TOL_R2
    want171 = np.stack([float_ref.mfcc_float(s, MFCCConfig(step=171))
                        for s in sig])
    assert np.abs(odd.cpu().numpy() - want171).max() <= GATE
    assert torch.equal(fast, float_fused.mfcc_radix2(
        x, MFCCConfig(), dft_passes=3))


def test_default_device_is_the_card(dev):
    fe = MFCC()
    assert all(b.device.type == "cuda" for b in fe.buffers())
    assert MFCC(device="cpu").window.device.type == "cpu"


def _int_inputs(seed=0):
    """(name, (S, T) input): tonal int16, full-range int16, silence, int32
    outside int16 range, one frame exactly, a ragged tail."""
    rng = np.random.default_rng(seed)
    return [
        ("tonal int16", _tonal(4, 16000, seed).astype(np.int16)),
        ("full-range int16", rng.integers(-32768, 32768, (3, 4000))
         .astype(np.int16)),
        ("silence", np.zeros((2, 3000), np.int16)),
        ("wide int32", rng.integers(-2 ** 31, 2 ** 31, (3, 5000))
         .astype(np.int32)),
        ("T=512", rng.integers(-32768, 32768, (5, 512)).astype(np.int16)),
        ("T=681", rng.integers(-32768, 32768, (5, 681)).astype(np.int16)),
    ]


@pytest.mark.parametrize("cfg", [MFCCConfig(), MIC_CONFIG,
                                 MFCCConfig(nfilters=16, nceptrums=16),
                                 MFCCConfig(step=160)],
                         ids=["default", "mic", "nfilters16", "hop160"])
def test_int_kernel_matches_plain(dev, cfg):
    """K2 equals its plain version element for element."""
    for name, x in _int_inputs():
        xt = torch.from_numpy(x).to(dev)
        before = int_fused.LAUNCHES["K2"]
        got = int_fused.mfcc_int_fused(xt, cfg)
        torch.cuda.synchronize()
        assert int_fused.LAUNCHES["K2"] == before + 1
        want = int_fused.mfcc_int_fused_plain(xt, cfg)
        assert got.dtype == torch.int32
        assert got.shape == (x.shape[0], cfg.n_frames(x.shape[1]),
                             cfg.nceptrums), name
        assert torch.equal(got, want), name


def test_int_frames_kernel_matches_plain(dev):
    """K3 on frames of several streams with two leading axes, and on int32
    frames outside int16 range."""
    x = torch.from_numpy(_tonal(4, 8000, 5).astype(np.int32)).to(dev)
    frames = framing.extract_frames(framing.preemphasis_int(x), 512, 170)
    frames = frames.reshape(2, 2, *frames.shape[1:]).contiguous()
    wide = torch.from_numpy(np.random.default_rng(6).integers(
        -2 ** 31, 2 ** 31, (3, 7, 512)).astype(np.int32)).to(dev)
    for f in (frames, wide):
        before = int_fused.LAUNCHES["K3"]
        got = int_fused.mfcc_int_fused_frames(f)
        torch.cuda.synchronize()
        assert int_fused.LAUNCHES["K3"] == before + 1
        assert got.shape == f.shape[:-1] + (32,)
        assert torch.equal(got, int_fused.mfcc_int_fused_frames_plain(f))
    assert torch.equal(int_fused.mfcc_int_fused_frames(frames).reshape(
        4, -1, 32), int_fused.mfcc_int_fused(x))


def test_int_module_on_card(dev):
    """MFCC().int on the card is element-exact with the oracle, and runs
    K2; int_frames runs K3."""
    sig = _tonal(2, 16000, 7).astype(np.int16)
    fe = MFCC()
    before = int_fused.LAUNCHES["K2"]
    got = fe.int(torch.from_numpy(sig).to(dev))
    assert int_fused.LAUNCHES["K2"] == before + 1
    want = np.stack([int_ref.mfcc_int(s) for s in sig])
    assert np.array_equal(got.cpu().numpy(), want)
    assert np.array_equal(fe.int(sig).cpu().numpy(), want)   # numpy input
    frames = framing.extract_frames(framing.preemphasis_int(
        torch.from_numpy(sig.astype(np.int32)).to(dev)), 512, 170)
    before = int_fused.LAUNCHES["K3"]
    assert np.array_equal(fe.int_frames(frames).cpu().numpy(), want)
    assert int_fused.LAUNCHES["K3"] == before + 1


def test_int_wrapper_checks_on_card(dev):
    x = torch.zeros(2, 4000, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int16 or torch.int32"):
        int_fused.mfcc_int_fused(x.float())
    with pytest.raises(ValueError, match="contiguous"):
        int_fused.mfcc_int_fused(torch.zeros(4000, 2, dtype=torch.int32,
                                             device=dev).t())
    with pytest.raises(TypeError, match="int32"):
        int_fused.mfcc_int_fused_frames(torch.zeros(3, 512, device=dev))
    with pytest.raises(ValueError, match="frames"):
        int_fused.mfcc_int_fused_frames(torch.zeros(3, 256, dtype=torch.int32,
                                                    device=dev))
    with pytest.raises(ValueError, match="shorter than one frame"):
        int_fused.mfcc_int_fused(x[:, :511].contiguous())


# -- the serving step K4 -----------------------------------------------------------

def _k4_run(dev, int_path, S, C, cfg, steps=4, seed=0, dft_passes=None):
    """A multi-step run of K4 and its plain version on the same inputs,
    with a reset of every other stream at step 2; chunks alternate int16,
    the state dtype (int32 INT chunks outside int16 range), and the layouts
    rotate.  Every feature slot and every carry are compared."""
    rng = np.random.default_rng(seed)
    P = cfg.nfft - 1
    sdt = torch.int32 if int_path else torch.float32
    step = (stream_fused.stream_step_int if int_path
            else stream_fused.stream_step_float)
    plain = (stream_fused.stream_step_int_plain if int_path
             else stream_fused.stream_step_float_plain)
    kernel = ("K4-INT" if int_path else
              "K4-split" if dft_passes in (3, 4) else "K4-float")
    carry = torch.zeros(S, P, dtype=sdt, device=dev)
    count = torch.zeros(S, dtype=torch.int32, device=dev)
    prev = torch.zeros(S, dtype=sdt, device=dev)
    err = 0.0
    for k in range(steps):
        if k % 2 == 0:
            x = torch.from_numpy(rng.integers(-32768, 32768, (S, C))
                                 .astype(np.int16))
        elif int_path:
            x = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (S, C))
                                 .astype(np.int32))
        else:
            x = torch.from_numpy((rng.integers(-25000, 25000, (S, C))
                                  + rng.random((S, C))).astype(np.float32))
        x = x.to(dev)
        if k == 2:
            count[::2] = 0
            prev[::2] = 0
        ts, layout = k % 2 == 1, ("time", "positions", "stream")[k % 3]
        xin = x.T.contiguous() if layout == "positions" else x
        cin = carry.T.contiguous() if ts else carry
        start = (P - count).to(torch.int32)
        kw = {} if int_path else dict(dft_passes=dft_passes)
        want = dict(stream_fused.LAUNCHES)
        want[kernel] += 1
        f, nc = step(cin, xin, start, prev, cfg, transposed_state=ts,
                     chunk_layout=layout, **kw)
        torch.cuda.synchronize()
        assert stream_fused.LAUNCHES == want
        fp, ncp = plain(cin, xin, start, prev, cfg, transposed_state=ts,
                        chunk_layout=layout, **kw)
        assert f.shape == fp.shape == (S, (C - 1) // cfg.hop + 1,
                                       cfg.nceptrums)
        assert torch.equal(nc, ncp), (k, layout, ts)
        if int_path:
            assert torch.equal(f, fp), (k, layout, ts)
        else:
            assert torch.isfinite(f).all()
            err = max(err, (f - fp).abs().max().item())
            if dft_passes in (3, 4):      # the same carry as K4-float's
                assert torch.equal(nc, step(cin, xin, start, prev, cfg,
                                            transposed_state=ts,
                                            chunk_layout=layout)[1])
        carry = nc.T if ts else nc
        total = count + C
        n_valid = torch.clamp_min((total - cfg.nfft) // cfg.hop + 1, 0)
        count = (total - n_valid * cfg.hop).to(torch.int32)
        prev = x[:, -1].to(sdt)
    assert err <= (TOL if dft_passes in (None, 6) else TOL_R2)


@pytest.mark.parametrize("int_path", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("C", [1, 170, 600, 1024, 2048])
@pytest.mark.parametrize("hop", [170, 160])
def test_stream_kernel_matches_plain(dev, int_path, C, hop):
    _k4_run(dev, int_path, 130, C, MFCCConfig(step=hop), seed=C + hop)


@pytest.mark.parametrize("int_path", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("C", [170, 1024, 1360, 1530])
def test_stream_kernel_tile_geometry(dev, int_path, C):
    """K4 float and INT against their plain versions where a stream's frame
    slots fill 1, 7, 8 and 9 of the tile's 8 warps (hop 170), at S=37."""
    _k4_run(dev, int_path, 37, C, MFCCConfig(), seed=C)


@pytest.mark.parametrize("S", [1, 3])
def test_warp_tails_ragged_tiles(dev, S):
    """F = 1 .. 17 frames a stream (partial, whole and two tiles of 8,
    one warp a frame): K1 within TOL of its plain version, K2, K3 and K10
    equal to theirs and to each other."""
    cfg = MFCCConfig()
    for F in range(1, 18):
        T = cfg.nfft + (F - 1) * cfg.hop + F % 3
        x = torch.from_numpy(_tonal(S, T, seed=F).astype(np.int16)).to(dev)
        got = fladder.mfcc_float_ladder(x, cfg)
        assert got.shape == (S, F, 32)
        assert (got - fladder.mfcc_float_ladder_plain(x, cfg)
                ).abs().max().item() <= TOL, F
        k2 = int_fused.mfcc_int_fused(x, cfg)
        assert torch.equal(k2, int_fused.mfcc_int_fused_plain(x, cfg)), F
        frames = framing.extract_frames(framing.preemphasis_int(
            x.to(torch.int32)), cfg.nfft, cfg.hop).contiguous()
        k3 = int_fused.mfcc_int_fused_frames(frames, cfg)
        assert torch.equal(k3, int_fused.mfcc_int_fused_frames_plain(
            frames, cfg)), F
        k10 = int_fused.mfcc_int_split2(x, cfg)
        assert torch.equal(k10, int_fused.mfcc_int_split2_plain(x, cfg)), F
        assert torch.equal(k3, k2) and torch.equal(k10, k2), F


def test_streaming_equals_batch_on_card(dev):
    """Streaming through K4 equals batch K2 element for element and batch
    K1 within TOL (bit for bit predicted: the same FP64 operations on the
    same values); K4 launches once per full-chunk step, K1/K2 never, K3 on
    the INT flush step."""
    sig = _tonal(8, 1024 * 12 + 300, 11).astype(np.int16)
    x = torch.from_numpy(sig).to(dev)
    fe = MFCC()
    for int_path in (True, False):
        k4 = dict(stream_fused.LAUNCHES)
        k4["K4-INT" if int_path else "K4-float"] += 12
        k3, k1 = dict(int_fused.LAUNCHES), fladder.LAUNCHES
        k3["K3"] += 1 if int_path else 0
        got, _ = StreamingMFCC(int_path=int_path).process(x, 1024)
        assert stream_fused.LAUNCHES == k4
        assert fladder.LAUNCHES == k1
        assert int_fused.LAUNCHES == k3
        want = (fe.int(x) if int_path else fe(x)).cpu().numpy()
        full = MFCCConfig().n_frames(1024 * 12)
        for s in range(len(sig)):
            assert got[s].shape == want[s].shape
            if int_path:
                assert np.array_equal(got[s], want[s])
            else:
                assert np.abs(got[s][:full] - want[s][:full]).max() <= TOL
                assert np.abs(got[s] - want[s]).max() <= GATE
    # int64 numpy chunks: the INT step takes them as int32 (a chunk column
    # becomes the next prev)
    got, _ = StreamingMFCC(int_path=True).process(sig.astype(np.int64), 1024)
    assert np.array_equal(np.stack(got), fe.int(x).cpu().numpy())


def test_stream_wrapper_checks_on_card(dev):
    P = 511
    buf = torch.zeros(4, P, device=dev)
    x = torch.zeros(4, 600, device=dev)
    start = torch.zeros(4, dtype=torch.int32, device=dev)
    prev = torch.zeros(4, device=dev)
    with pytest.raises(TypeError, match="chunk"):
        stream_fused.stream_step_float(buf, x.double(), start, prev)
    with pytest.raises(ValueError, match="is on cpu"):
        stream_fused.stream_step_float(buf, x, start.cpu(), prev)
    with pytest.raises(ValueError, match="do not fit"):
        stream_fused.stream_step_float(buf[:, :200], x, start, prev)
    # a refused launch (P does not fit nfft) raises with its cudaError_t
    lib = build.library()
    with pytest.raises(RuntimeError, match="cudaError_t"):
        build.launch(lib.mfcc_stream_int_i16, dev, *([0] * 10), 4,
                             100, 600, 4, 170, *([1] * 6), 32, 32, 0, 11,
                             15, *([0] * 4))


# -- the step-level K4 entries: the whole full-chunk step in one launch -------

STATE_WIDTHS = [1, 169, 170, 171, 600, 1024, 2048]


def _k4_state_run(dev, int_path, S, C, cfg, steps=4, seed=0, count0=None):
    """A multi-step run of the step-level K4 entry (``stream_step_*_state``:
    the reset merged and the state updated in the kernel) and its plain
    version on the same inputs, with a random reset pattern on every step
    but the first (None there: no reset); chunks alternate int16 and the
    state dtype (int32 outside int16 range, float values that are not
    integers), the layouts rotate.  ``count0`` (S,): the first step's
    counts, over a random carry, else an empty state.  INT features and,
    for both, mask, carry, count and prev ``torch.equal``; float features
    within TOL."""
    rng = np.random.default_rng(seed)
    P = cfg.nfft - 1
    sdt = torch.int32 if int_path else torch.float32
    kern = (stream_fused.stream_step_int_state if int_path
            else stream_fused.stream_step_float_state)
    plain = (stream_fused.stream_step_int_state_plain if int_path
             else stream_fused.stream_step_float_state_plain)
    key = "K4-INT" if int_path else "K4-float"
    if count0 is None:
        carry = torch.zeros(S, P, dtype=sdt, device=dev)
        count = torch.zeros(S, dtype=torch.int32, device=dev)
    else:
        carry = torch.from_numpy(rng.integers(-3000, 3000, (S, P))).to(
            dev, sdt)
        count = torch.as_tensor(count0, dtype=torch.int32, device=dev)
    prev = torch.from_numpy(rng.integers(-3000, 3000, S)).to(dev, sdt)
    err = 0.0
    for k in range(steps):
        if k % 2 == 0:
            x = rng.integers(-32768, 32768, (S, C)).astype(np.int16)
        elif int_path:
            x = rng.integers(-2 ** 31, 2 ** 31, (S, C)).astype(np.int32)
        else:
            x = (rng.integers(-25000, 25000, (S, C))
                 + rng.random((S, C))).astype(np.float32)
        x = torch.from_numpy(x).to(dev)
        reset = (None if k == 0 else
                 torch.from_numpy(rng.random(S) < 0.3).to(dev))
        ts, layout = k % 2 == 1, ("time", "positions", "stream")[k % 3]
        xin = x.T.contiguous() if layout == "positions" else x
        cin = carry.T.contiguous() if ts else carry
        want = dict(stream_fused.LAUNCHES)
        want[key] += 1
        got = kern(cin, xin, count, prev, reset, cfg, transposed_state=ts,
                   chunk_layout=layout)
        torch.cuda.synchronize()
        assert stream_fused.LAUNCHES == want
        ref = plain(cin, xin, count, prev, reset, cfg, transposed_state=ts,
                    chunk_layout=layout)
        f, fp = got[0], ref[0]
        assert f.shape == fp.shape == (S, (C - 1) // cfg.hop + 1,
                                       cfg.nceptrums)
        for name, a, b in zip(("mask", "carry", "count", "prev"), got[1:],
                              ref[1:]):
            assert a.dtype == b.dtype and torch.equal(a, b), (k, name,
                                                              layout, ts)
        if int_path:
            assert torch.equal(f, fp), (k, layout, ts)
        else:
            m = got[1]
            assert torch.isfinite(f[m]).all()
            if bool(m.any()):
                err = max(err, (f[m] - fp[m]).abs().max().item())
        carry = got[2].T if ts else got[2]
        count, prev = got[3], got[4]
    assert err <= TOL
    return err


@pytest.mark.parametrize("int_path", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("C", STATE_WIDTHS)
def test_stream_state_kernel_matches_plain(dev, int_path, C):
    _k4_state_run(dev, int_path, 130, C, MFCCConfig(), seed=C)


@pytest.mark.parametrize("int_path", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("C", [1, 170, 171])
def test_stream_state_floor_division_on_card(dev, int_path, C):
    """Counts 0 .. 511 and 64 random ones: count + C - 512 lands in (-170,
    0) and in every residue mod 170 (at C = 170 and 171), where C++'s
    truncating division would give one frame too many; the kernel's mask
    and count are its plain version's and the floor division's."""
    rng = np.random.default_rng(C)
    count0 = np.concatenate([np.arange(512), rng.integers(0, 512, 64)])
    _k4_state_run(dev, int_path, len(count0), C, MFCCConfig(), steps=2,
                  seed=C, count0=count0)
    sm = StreamingMFCC(int_path=int_path)
    st = sm.init(len(count0))
    st = st._replace(count=torch.as_tensor(count0, dtype=torch.int32,
                                           device=dev))
    x = torch.zeros(len(count0), C, dtype=torch.int16, device=dev)
    _, mask, new = sm.step(x, st)
    total = count0 + C
    n_valid = np.maximum((total - 512) // 170 + 1, 0)
    assert np.array_equal(mask.sum(dim=1).cpu().numpy(), n_valid)
    assert np.array_equal(new.count.cpu().numpy(), total - n_valid * 170)


# -- K4's staged window against its per-point kernels -------------------------

WINDOW_WIDTHS = [1, 169, 170, 171, 600, 1024, 1360, 1530, 2048]


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits, so that NaN slots compare as equal bits."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _k4_window_run(dev, int_path, S, C, steps=3, seed=0):
    """The step-level K4 entry on (S, P) carries and (S, C) chunks (the
    staged window) against the same entry on the same values read through
    a chunk with a position stride of 2 (the per-point kernels) and its
    plain version: random carries, counts 0, P and random, random resets
    after the first step, chunks int16 then int32 (INT) or f32 with
    fractions (float).  Features of every slot, masked included, bit for
    bit between the two kernels (INT also equal to the plain version; float
    within TOL of it on the valid slots); mask, carry, count and prev equal
    among all three.  The JAX-signature entry takes the same routes.
    ``STAGED_LAUNCHES`` rises by one for each (S, C) launch where
    ``stream_fused.staged`` holds (the rows of a tile's streams fit the
    kernel's row buffer: every INT width here, the float kernel's int16
    widths 600 to 1530), by none for the strided ones."""
    cfg = MFCCConfig()
    rng = np.random.default_rng(seed)
    P = cfg.nfft - 1
    sdt = torch.int32 if int_path else torch.float32
    kern = (stream_fused.stream_step_int_state if int_path
            else stream_fused.stream_step_float_state)
    plain = (stream_fused.stream_step_int_state_plain if int_path
             else stream_fused.stream_step_float_state_plain)
    jax_sig = (stream_fused.stream_step_int if int_path
               else stream_fused.stream_step_float)
    key = "K4-INT" if int_path else "K4-float"
    carry = torch.from_numpy(rng.integers(-3000, 3000, (S, P))).to(dev, sdt)
    count = rng.integers(0, P + 1, S)
    count[::3], count[1::3] = 0, P
    count = torch.as_tensor(count, dtype=torch.int32, device=dev)
    prev = torch.from_numpy(rng.integers(-3000, 3000, S)).to(dev, sdt)
    err = 0.0
    for k in range(steps):
        if k % 2 == 0:
            x = rng.integers(-32768, 32768, (S, C)).astype(np.int16)
        elif int_path:
            x = rng.integers(-2 ** 31, 2 ** 31, (S, C)).astype(np.int32)
        else:
            x = (rng.integers(-25000, 25000, (S, C))
                 + rng.random((S, C))).astype(np.float32)
        x = torch.from_numpy(x).to(dev)
        wide = torch.zeros((S, 2 * C), dtype=x.dtype, device=dev)
        wide[:, ::2] = x
        strided = wide[:, ::2]                 # chunk_t = 2: per-point
        reset = (None if k == 0 else
                 torch.from_numpy(rng.random(S) < 0.3).to(dev))
        n, staged_n = dict(stream_fused.LAUNCHES), dict(
            stream_fused.STAGED_LAUNCHES)
        window = stream_fused.staged(key, (C - 1) // cfg.hop + 1, C,
                                     cfg.nfft, x.element_size(),
                                     (P, 1, C, 1))
        got = kern(carry, x, count, prev, reset, cfg)
        n[key] += 1
        staged_n[key] += window
        assert stream_fused.LAUNCHES == n
        assert stream_fused.STAGED_LAUNCHES == staged_n
        pointwise = kern(carry, strided, count, prev, reset, cfg)
        n[key] += 1
        assert stream_fused.LAUNCHES == n
        assert stream_fused.STAGED_LAUNCHES == staged_n
        torch.cuda.synchronize()
        ref = plain(carry, x, count, prev, reset, cfg)
        assert got[0].shape == (S, (C - 1) // cfg.hop + 1, cfg.nceptrums)
        assert torch.equal(_bits(got[0]), _bits(pointwise[0])), (S, C, k)
        for name, a, b, c in zip(("mask", "carry", "count", "prev"),
                                 got[1:], pointwise[1:], ref[1:]):
            assert a.dtype == c.dtype, name
            assert torch.equal(a, b) and torch.equal(a, c), (S, C, k, name)
        if int_path:
            assert torch.equal(got[0], ref[0]), (S, C, k)
        else:
            m = got[1]
            if bool(m.any()):
                assert torch.isfinite(got[0][m]).all()
                err = max(err, (got[0][m] - ref[0][m]).abs().max().item())
        # the JAX-signature entry: the same kernels by the same test
        merged = (count if reset is None
                  else torch.where(reset, 0, count)).to(torch.int32)
        pv = prev if reset is None else torch.where(
            reset, torch.zeros_like(prev), prev)
        start = (P - merged).to(torch.int32)
        f1, c1 = jax_sig(carry, x, start, pv, cfg)
        staged_n[key] += window
        f2, c2 = jax_sig(carry, strided, start, pv, cfg)
        assert stream_fused.STAGED_LAUNCHES == staged_n
        assert torch.equal(_bits(f1), _bits(got[0]))
        assert torch.equal(_bits(f2), _bits(got[0]))
        assert torch.equal(c1, got[2]) and torch.equal(c2, got[2])
        carry, count, prev = got[2], got[3], got[4]
    assert err <= TOL


@pytest.mark.parametrize("int_path", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("C", WINDOW_WIDTHS)
def test_stream_window_matches_pointwise(dev, int_path, C):
    """The staged window at S = 1, 3, 37 and 130 (a tile spans 1 to 8
    streams: F = 1, 2, 4, 7, 8, 9, 13) against the per-point kernels and
    the plain version (``_k4_window_run``)."""
    for S in (1, 3, 37, 130):
        _k4_window_run(dev, int_path, S, C, seed=S * 7919 + C)


@pytest.mark.parametrize("int_path", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("C", [170, 1024, 2048])
def test_stream_window_at_serving_streams(dev, int_path, C):
    """The same at S = 4096, the serving cells' streams."""
    _k4_window_run(dev, int_path, 4096, C, steps=2, seed=C)


def test_stream_window_transposed_takes_pointwise(dev):
    """A step on the (P, S) carry or the (C, S) chunk takes the per-point
    kernels (``STAGED_LAUNCHES`` does not move, ``LAUNCHES`` does), on
    both steps, with the staged step's bits."""
    cfg, S, C = MFCCConfig(), 37, 1024
    x = torch.from_numpy(_tonal(S, C, 5).astype(np.int16)).to(dev)
    for int_path in (True, False):
        sm = StreamingMFCC(int_path=int_path)
        key = "K4-INT" if int_path else "K4-float"
        state = sm.init(S)
        n, staged_n = (dict(stream_fused.LAUNCHES),
                       dict(stream_fused.STAGED_LAUNCHES))
        want = sm.step(x, state)
        n[key] += 1
        staged_n[key] += 1
        for ts, chunks in ((True, x), (False, x.T.contiguous()),
                           (True, x.T.contiguous())):
            other = StreamingMFCC(int_path=int_path, transposed_state=ts,
                                  transposed_chunks=chunks.shape[0] != S)
            st = other.init(S)
            got = other.step(chunks, st)
            n[key] += 1
            assert stream_fused.LAUNCHES == n
            assert stream_fused.STAGED_LAUNCHES == staged_n
            assert torch.equal(_bits(got[0]), _bits(want[0]))
            assert torch.equal(got[1], want[1])


def test_stream_window_test_is_the_kernels(dev):
    """``stream_fused.staged``, the wrapper's mirror of the kernels' test,
    answers as the C entry ``mfcc_stream_staged`` for both steps over chunk
    widths, hops, sample sizes and strides: rows over a buffer, rows not
    back to back and the transposed layouts included."""
    lib = build.library()
    P = 511
    for int_step, key in ((0, "K4-float"), (1, "K4-INT")):
        for C in (1, 169, 170, 171, 600, 1024, 1360, 1530, 1550, 2048, 4000,
                  9000):
            for hop in (160, 170, 600):
                F = (C - 1) // hop + 1
                for b in (2, 4):
                    for st in ((P, 1, C, 1), (P + 1, 1, C, 1),
                               (P, 1, C + 2, 1), (1, 4096, C, 1),
                               (P, 1, 1, 4096), (P, 2, C, 1)):
                        want = bool(lib.mfcc_stream_staged(
                            int_step, F, C, 512, b, *st))
                        got = stream_fused.staged(key, F, C, 512, b, st)
                        assert got == want, (key, C, hop, b, st)


def test_streamed_frames_are_batch_bits_on_card(dev):
    """int16 streams through full-chunk ``StreamingMFCC`` steps (one launch
    of the step-level kernel each, resets none) give batch K1's float
    frames bit for bit and K2's INT frames element for element."""
    sig = _tonal(16, 1024 * 10, 13).astype(np.int16)
    x = torch.from_numpy(sig).to(dev)
    fe = MFCC()
    for int_path in (True, False):
        before = dict(stream_fused.LAUNCHES)
        got, _ = StreamingMFCC(int_path=int_path).process(x, 1024)
        before["K4-INT" if int_path else "K4-float"] += 10
        assert stream_fused.LAUNCHES == before
        want = (fe.int(x) if int_path else fe(x)).cpu().numpy()
        assert np.array_equal(np.stack(got), want)


def _device_ops(fn):
    """The names of the operations ``fn`` runs on the card (kernels,
    copies, fills), from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("int_path", [True, False], ids=["int", "float"])
def test_full_step_is_one_kernel_on_card(dev, int_path):
    """One full-chunk ``StreamingMFCC.step`` on the card runs exactly one
    operation there, K4's kernel, with or without a reset (outputs from
    the caching allocator after warm-up); the K4 launch count moves by
    one."""
    S, C = 256, 1024
    sm = StreamingMFCC(int_path=int_path)
    x = torch.from_numpy(_tonal(S, C, 3).astype(np.int16)).to(dev)
    reset = torch.zeros(S, dtype=torch.bool, device=dev)
    reset[::5] = True
    state = sm.init(S)
    for r in (None, reset, None):                    # warm-up
        _, _, state = sm.step(x, state, reset=r)
    key = "K4-INT" if int_path else "K4-float"
    for r in (None, reset):
        n = stream_fused.LAUNCHES[key]
        ops = _device_ops(lambda: sm.step(x, state, reset=r))
        assert len(ops) == 1, ops
        assert ("stream_int_kernel" if int_path
                else "stream_f32_kernel") in ops[0], ops
        assert stream_fused.LAUNCHES[key] == n + 1


@pytest.mark.parametrize("passes", [3, 4])
@pytest.mark.parametrize("C", [1, 170, 600, 1024, 2048])
def test_split_stream_kernel_matches_plain(dev, C, passes):
    before = stream_fused.LAUNCHES["K4-split"]
    _k4_run(dev, False, 130, C, MFCCConfig(), seed=C + passes,
            dft_passes=passes)
    assert stream_fused.LAUNCHES["K4-split"] == before + 4


def test_stream_fast_on_card(dev):
    """``StreamingMFCC(precision="fast")`` runs the split-DFT step on every
    full chunk (it raised before the step was ported): int16 streams are
    bit-identical to batch K5 at 3 passes on the frames of full steps; the
    flush frames take the "highest" chain, within GATE of the oracle."""
    sig = _tonal(6, 1024 * 8 + 300, 31).astype(np.int16)
    x = torch.from_numpy(sig).to(dev)
    before = (dict(stream_fused.LAUNCHES), dict(float_fused.LAUNCHES))
    before[0]["K4-split"] += 8
    got, _ = StreamingMFCC(precision="fast").process(x, 1024)
    assert stream_fused.LAUNCHES == before[0]
    assert float_fused.LAUNCHES == before[1]
    want = MFCC(precision="fast")(x).cpu().numpy()
    full = MFCCConfig().n_frames(1024 * 8)
    for s in range(len(sig)):
        assert got[s].shape == want[s].shape
        assert np.isfinite(got[s]).all()
        assert np.array_equal(got[s][:full], want[s][:full])
        oracle = float_ref.mfcc_float(sig[s])
        assert np.abs(got[s][full:] - oracle[full:]).max() <= GATE


def test_feature_server_on_card(dev):
    sig = _tonal(1, 3000, 12)[0].astype(np.int16)
    srv = FeatureServer(MFCCConfig(), max_streams=4, chunk=1024).start()
    try:
        assert srv.device.type == "cuda"
        host, port = srv.address
        got = stream_samples(host, port, sig, 32, timeout=60)
        assert np.array_equal(got, int_ref.mfcc_int(sig).astype(np.int16))
    finally:
        srv.stop()


@pytest.mark.parametrize("nfft,hop", [(256, 86), (512, 170), (1024, 340)])
def test_f64ish_kernel_matches_plain(dev, nfft, hop):
    """K7 (int16, f32 on and off the wire grid, wire_grid False) and
    K7-frames against their plain versions, one launch per call."""
    cfg = MFCCConfig(nfft=nfft, step=hop)
    sig = _tonal(6, 9000, seed=nfft + 7)
    for x, wg in ((sig.astype(np.int16), True), (sig, True),
                  (sig / np.float32(32768), True),
                  (sig / np.float32(32768), False)):
        xt = torch.from_numpy(np.array(x)).to(dev)
        before = f64ish.LAUNCHES["K7"]
        got = f64ish.mfcc_f64ish(xt, cfg, wire_grid=wg)
        torch.cuda.synchronize()
        assert f64ish.LAUNCHES["K7"] == before + 1
        want = f64ish.mfcc_batch_f64ish_plain(xt, cfg, wire_grid=wg)
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= TOL
    frames = framing.extract_frames(framing.preemphasis(
        torch.from_numpy(sig / np.float32(32768)).to(dev)), nfft, hop)
    frames = frames[:, :-1].contiguous()
    before = f64ish.LAUNCHES["K7-frames"]
    got = f64ish.mfcc_f64ish_frames(frames, cfg)
    torch.cuda.synchronize()
    assert f64ish.LAUNCHES["K7-frames"] == before + 1
    assert got.shape == frames.shape[:-1] + (32,)
    want = f64ish.mfcc_frames_f64ish_plain(frames, cfg)
    assert (got - want).abs().max().item() <= TOL


def test_f64ish_grid_ties_on_card(dev):
    """K7-frames rounds x*32 = k + 0.5 half to even, as the plain version
    and ``jnp.round``."""
    k = torch.from_numpy(np.random.default_rng(1).integers(
        -2 ** 19, 2 ** 19, (3, 5, 512)).astype(np.float64)).to(dev)
    ties = ((k + 0.5) / 32).float()
    even = (torch.round(ties.double() * 32) / 32).float()
    got = f64ish.mfcc_f64ish_frames(ties, MFCCConfig())
    assert torch.equal(got, f64ish.mfcc_f64ish_frames(even, MFCCConfig(),
                                                      wire_grid=False))
    want = f64ish.mfcc_frames_f64ish_plain(ties, MFCCConfig())
    assert (got - want).abs().max().item() <= TOL


def test_f64ish_routes_on_card(dev):
    """``MFCC(precision="f64ish")`` launches K7 (never K1), ``.frames``
    K7-frames; both within the f64ish gate of the oracle; an
    out-of-family config takes the float64 chain on the card."""
    sig = _tonal(2, 512 + 6 * 170, seed=17)
    x = torch.from_numpy(sig.astype(np.int16)).to(dev)
    frames = framing.extract_frames(framing.preemphasis(
        torch.from_numpy(sig).to(dev)), 512, 170)
    fe = MFCC(precision="f64ish")
    before, k1 = dict(f64ish.LAUNCHES), fladder.LAUNCHES
    out, out_f = fe(x), fe.frames(frames)
    torch.cuda.synchronize()
    assert f64ish.LAUNCHES == {"K7": before["K7"] + 1,
                               "K7-frames": before["K7-frames"] + 1}
    assert fladder.LAUNCHES == k1
    want = np.stack([float_ref.mfcc_float(s) for s in sig])
    assert gate_units(out.cpu().numpy(), want) <= 1.0
    assert gate_units(out_f.cpu().numpy(), want) <= 1.0
    assert (out - out_f).abs().max().item() <= TOL
    cfg = MFCCConfig(window_samples=400)
    before = dict(f64ish.LAUNCHES)
    chain = MFCC(cfg, precision="f64ish")(x)
    assert f64ish.LAUNCHES == before
    cpu = MFCC(cfg, precision="f64ish", device="cpu")(x.cpu())
    assert (chain.cpu() - cpu).abs().max().item() <= TOL


def test_stream_f64ish_on_card(dev):
    """``StreamingMFCC(precision="f64ish")`` runs K7-frames once per step,
    flush included, and matches batch K7."""
    sig = _tonal(5, 1024 * 6 + 300, 33).astype(np.int16)
    x = torch.from_numpy(sig).to(dev)
    before = dict(f64ish.LAUNCHES)
    got, _ = StreamingMFCC(precision="f64ish").process(x, 1024)
    assert f64ish.LAUNCHES == {"K7": before["K7"],
                               "K7-frames": before["K7-frames"] + 7}
    want = f64ish.mfcc_f64ish(x).cpu().numpy()
    for s in range(len(sig)):
        assert got[s].shape == want[s].shape
        assert np.abs(got[s] - want[s]).max() <= TOL


@pytest.mark.parametrize("nfft,hop", [(256, 86), (512, 170), (1024, 340)])
def test_f64ish_persistent_walk_on_card(dev, nfft, hop):
    """K7 and K7-frames in their persistent grids on ragged shapes: S*F not
    a multiple of 8 (3 x 5), F = 1, S = 1, one frame; K7 on int16 equal to
    K1 bit for bit and within TOL of its plain version on int16 and on
    [-1, 1] f32 on and off the wire grid; K7-frames within TOL on M < 8
    rows and on 9."""
    cfg = MFCCConfig(nfft=nfft, step=hop)
    for S, F in ((3, 5), (13, 1), (1, 21), (1, 1)):
        T = nfft + (F - 1) * hop + F % 3
        sig = _tonal(S, T, seed=S * 31 + F)
        x16 = torch.from_numpy(sig.astype(np.int16)).to(dev)
        got = f64ish.mfcc_f64ish(x16, cfg)
        assert got.shape == (S, F, 32)
        assert torch.equal(got, fladder.mfcc_float_ladder(x16, cfg)), (S, F)
        xf = torch.from_numpy(sig / np.float32(32768)).to(dev)
        for x, wg in ((x16, True), (xf, True), (xf, False)):
            got = f64ish.mfcc_f64ish(x, cfg, wire_grid=wg)
            want = f64ish.mfcc_batch_f64ish_plain(x, cfg, wire_grid=wg)
            assert (got - want).abs().max().item() <= TOL, (S, F, wg)
    for M in (1, 5, 7, 9):
        fr = torch.from_numpy(np.random.default_rng(M).uniform(
            -1, 1, (M, nfft)).astype(np.float32)).to(dev)
        got = f64ish.mfcc_f64ish_frames(fr, cfg)
        assert got.shape == (M, 32)
        want = f64ish.mfcc_frames_f64ish_plain(fr, cfg)
        assert (got - want).abs().max().item() <= TOL, M


def test_f64ish_many_frames_a_warp_on_card(dev):
    """At S=1024 x 4 s (382,976 frames: over 100 a resident warp at 3
    blocks of 8 warps an SM) K7 on int16 equals K1 bit for bit and
    K7-frames its plain version within TOL."""
    x = torch.from_numpy(_tonal(1024, 63_922, 5).astype(np.int16)).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert 1024 * 374 > 100 * sms * 3 * 8
    assert torch.equal(f64ish.mfcc_f64ish(x), fladder.mfcc_float_ladder(x))
    frames = framing.extract_frames(framing.preemphasis(x.float()), 512, 170)
    got = f64ish.mfcc_f64ish_frames(frames)
    want = f64ish.mfcc_frames_f64ish_plain(frames)
    assert (got - want).abs().max().item() <= TOL


def test_split_and_segmented_on_card(dev):
    """The split chain and the segmented formulation on the card hold the
    float gate on the JAX bench's gate input (2 streams x 5 frames)."""
    sig = _tonal(2, 512 + 4 * 170, seed=7)
    x = torch.from_numpy(sig).to(dev)
    want = np.stack([float_ref.mfcc_float(s) for s in sig])
    for kw in (dict(precision="split"), dict(method="segmented"),
               dict(method="segmented", precision="split")):
        got = MFCC(**kw)(x).cpu().numpy()
        assert np.abs(got - want).max() <= GATE, kw


# -- K8: the dense-DFT entries --------------------------------------------------------

DENSE = ("mfcc_emphasized", "mfcc_batch_dense", "mfcc_raw", "mfcc_aligned",
         "mfcc_recomp", "mfcc_seg", "mfcc_fmaj")


def _dense_input(name, x):
    """The entry's input: emphasized f32 for ``mfcc_emphasized``."""
    return framing.preemphasis(x.float()) if name == "mfcc_emphasized" else x


@pytest.mark.parametrize("nfft,hop", [(256, 86), (512, 170), (1024, 340)])
def test_dense_kernel_matches_plain(dev, nfft, hop):
    """Every K8 entry's kernel against its plain version within TOL on
    int16 and non-integer f32 input with a ragged last tile, one launch of
    its own key per call."""
    cfg = MFCCConfig(nfft=nfft, step=hop)
    sig = _tonal(5, 9000, seed=nfft)
    noisy = sig + np.random.default_rng(nfft).random(sig.shape,
                                                     dtype=np.float32)
    for x in (torch.from_numpy(sig.astype(np.int16)), torch.from_numpy(noisy)):
        x = x.to(dev)
        for name in DENSE:
            if name == "mfcc_aligned" and nfft != 512:
                continue
            xin = _dense_input(name, x)
            before = sum(dense_fused.LAUNCHES.values())
            got = getattr(dense_fused, name)(xin, cfg)
            torch.cuda.synchronize()
            assert sum(dense_fused.LAUNCHES.values()) == before + 1
            want = getattr(dense_fused, name + "_plain")(xin, cfg)
            assert got.shape == want.shape == (5, cfg.n_frames(9000), 32)
            assert bool(torch.isfinite(got).all()), name
            assert (got - want).abs().max().item() <= TOL, name


def test_dense_knobs_on_card(dev):
    """The split knob both ways, int16 and integer-valued f32 input alike,
    leading axes, and fmaj on silence: finite with ``mel_floor`` (within
    TOL of the plain version), not finite without it."""
    sig = _tonal(4, 6000, seed=3)
    x16 = torch.from_numpy(sig.astype(np.int16)).to(dev)
    xf = torch.from_numpy(sig).to(dev)
    for split in (False, True):
        for fn, plain in ((dense_fused.mfcc_recomp,
                           dense_fused.mfcc_recomp_plain),
                          (dense_fused.mfcc_batch_dense,
                           dense_fused.mfcc_batch_dense_plain)):
            got = fn(x16, split=split)
            assert torch.equal(got, fn(xf, split=split))
            assert (got - plain(x16, split=split)).abs().max().item() <= TOL
    got = dense_fused.mfcc_raw(x16.reshape(2, 2, -1))
    assert torch.equal(got.reshape(4, *got.shape[2:]),
                       dense_fused.mfcc_raw(x16))
    silent = torch.zeros(2, 4000, dtype=torch.int16, device=dev)
    floored = dense_fused.mfcc_fmaj(silent, mel_floor=1.0)
    assert bool(torch.isfinite(floored).all())
    assert (floored - dense_fused.mfcc_fmaj_plain(silent, mel_floor=1.0)
            ).abs().max().item() <= TOL
    assert not bool(torch.isfinite(dense_fused.mfcc_fmaj(silent)).any())


def test_dense_gates_on_card(dev):
    """Against the float64 oracle: the f32-operand entries and raw within
    GATE on 2 x 1 s of tonal audio; every entry within GATE on the JAX
    bench's gate input (2 streams x 5 frames), where the split ones hold
    it."""
    cfg = MFCCConfig()
    for sig, names in ((_tonal(2, 16000, seed=9),
                        ("mfcc_emphasized", "mfcc_batch_dense", "mfcc_raw",
                         "mfcc_fmaj")),
                       (_tonal(2, 512 + 4 * 170, seed=7), DENSE)):
        want = np.stack([float_ref.mfcc_float(s, cfg) for s in sig])
        x = torch.from_numpy(sig.astype(np.int16)).to(dev)
        for name in names:
            got = getattr(dense_fused, name)(_dense_input(name, x), cfg)
            assert np.abs(got.cpu().numpy() - want).max() <= GATE, name


def test_dense_wrapper_checks_on_card(dev):
    x = torch.zeros(2, 4000, dtype=torch.int16, device=dev)
    with pytest.raises(ValueError, match="hop 170"):
        dense_fused.mfcc_aligned(x, MFCCConfig(step=160))
    with pytest.raises(ValueError, match="shorter than one frame"):
        dense_fused.mfcc_fmaj(x[:, :511])
    before = dict(dense_fused.LAUNCHES)
    got = dense_fused.mfcc_emphasized(x)        # int16 emphasized: cast to f32
    assert got.dtype == torch.float32
    assert dense_fused.LAUNCHES["emphasized"] == before["emphasized"] + 1


# -- K9, K3-v1 and K10: the remaining INT entries ---------------------------------------

def test_int_entries_match_plain_and_k2(dev):
    """K9, K3-v1 and K10 equal their plain versions element for element,
    and K2 under its wire rule (K3-v1 only on int16 input; on int32 outside
    the int16 range it equals the oracle instead); one launch per kernel
    under its own key."""
    for name, x in _int_inputs():
        xt = torch.from_numpy(x).to(dev)
        k2 = int_fused.mfcc_int_fused(xt)
        for fn, plain, keys in (
                (int_fused.mfcc_int_v2, int_fused.mfcc_int_fused_plain,
                 ("K9",)),
                (int_fused.mfcc_int_v1, int_fused.mfcc_int_v1_plain,
                 ("K3-v1",)),
                (int_fused.mfcc_int_split2, int_fused.mfcc_int_split2_plain,
                 ("K10-front", "K10-epi"))):
            want_n = dict(int_fused.LAUNCHES)
            for k in keys:
                want_n[k] += 1
            got = fn(xt)
            torch.cuda.synchronize()
            assert int_fused.LAUNCHES == want_n, name
            assert torch.equal(got, plain(xt)), name
            if fn is not int_fused.mfcc_int_v1 or x.dtype == np.int16:
                assert torch.equal(got, k2), name
        if x.dtype == np.int32:
            want = np.stack([int_ref.mfcc_int(s.astype(np.int64)) for s in x])
            assert np.array_equal(int_fused.mfcc_int_v1(xt).cpu().numpy(),
                                  want)


def test_int_split2_stages_on_card(dev):
    """K10's launches one at a time: the power rows equal the plain front's
    and the epilogue on them equals the plain epilogue and K2."""
    x = torch.from_numpy(_tonal(3, 7000, 4).astype(np.int16)).to(dev)
    power = int_fused.mfcc_int_front(x)
    assert power.shape == (3, MFCCConfig().n_frames(7000), 256)
    assert torch.equal(power, int_fused.mfcc_int_front_plain(x))
    assert torch.equal(int_fused.mfcc_int_epi(power),
                       int_fused.mfcc_int_epi_plain(power))
    assert torch.equal(int_fused.mfcc_int_epi(power),
                       int_fused.mfcc_int_fused(x))
    with pytest.raises(ValueError, match="power rows"):
        int_fused.mfcc_int_epi(power[..., :128].contiguous())
    with pytest.raises(TypeError, match="int16 or torch.int32"):
        int_fused.mfcc_int_v2(x.float())


# row counts of the persistent K3 and K10-epilogue walks: one row, fewer
# than a block's 8 warps, not a multiple of 8, and several times the
# resident warps (132 SMs x 4 blocks x 8 warps = 4,224)
RAGGED_ROWS = (1, 5, 7, 9, 23, 3 * 4224 + 5)


@pytest.mark.parametrize("nf", [32, 16])
def test_balanced_tails_on_ragged_rows(dev, nf):
    """K3 and K10's epilogue, both on the balanced filterbank in a
    persistent grid, equal their plain versions element for element on
    ragged row counts (tonal and out-of-range int32 frames; power rows up
    to the top of their 30-bit range) and with two leading axes; one
    launch a call; K10 still equals K2."""
    cfg = MFCCConfig(nfilters=nf, nceptrums=nf)
    rng = np.random.default_rng(nf)
    M = max(RAGGED_ROWS)
    wide = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (M, 512))
                            .astype(np.int32)).to(dev)
    x = torch.from_numpy(_tonal(2, 16000, nf).astype(np.int32)).to(dev)
    tonal = framing.extract_frames(framing.preemphasis_int(x), 512,
                                   cfg.hop).reshape(-1, 512)
    power = torch.from_numpy(rng.integers(0, 2 ** 30, (M, 256))
                             .astype(np.int32)).to(dev)
    power[:3] = 2 ** 30 - 1
    for m in RAGGED_ROWS:
        for name, f in (("wide", wide[:m]), ("tonal", tonal[:m])):
            want_n = dict(int_fused.LAUNCHES)
            want_n["K3"] += 1
            got = int_fused.mfcc_int_fused_frames(f, cfg)
            torch.cuda.synchronize()
            assert int_fused.LAUNCHES == want_n
            assert torch.equal(got, int_fused.mfcc_int_fused_frames_plain(
                f, cfg)), (name, m)
        want_n = dict(int_fused.LAUNCHES)
        want_n["K10-epi"] += 1
        got = int_fused.mfcc_int_epi(power[:m], cfg)
        torch.cuda.synchronize()
        assert int_fused.LAUNCHES == want_n
        assert torch.equal(got, int_fused.mfcc_int_epi_plain(power[:m], cfg)), m
    lead = wide[:2 * 3 * 7].reshape(2, 3, 7, 512)
    assert torch.equal(int_fused.mfcc_int_fused_frames(lead, cfg),
                       int_fused.mfcc_int_fused_frames_plain(lead, cfg))
    lead = power[:2 * 5 * 9].reshape(2, 5, 9, 256)
    got = int_fused.mfcc_int_epi(lead, cfg)
    assert got.shape == (2, 5, 9, nf)
    assert torch.equal(got, int_fused.mfcc_int_epi_plain(lead, cfg))
    a = torch.from_numpy(_tonal(3, 9000, nf).astype(np.int16)).to(dev)
    assert torch.equal(int_fused.mfcc_int_split2(a, cfg),
                       int_fused.mfcc_int_fused(a, cfg))


@pytest.mark.parametrize("nf", [32, 16])
def test_audio_kernels_on_the_balanced_filterbank(dev, nf):
    """K2, K9 and K3-v1, K2's kernel on the balanced filterbank, equal
    their plain versions element for element at 16 and 32 filters: T of
    exactly one frame at S = 1 and S = 7, ragged S and T, two leading
    axes, full-range int32, and more frames than the grid's resident
    warps (132 SMs x 4 blocks x 8 warps); one launch a call under each
    key."""
    cfg = MFCCConfig(nfilters=nf, nceptrums=nf)
    rng = np.random.default_rng(100 + nf)
    inputs = [
        ("S=1, T=512", rng.integers(-32768, 32768, (1, 512))),
        ("S=7, T=512", rng.integers(-32768, 32768, (7, 512))),
        ("ragged S and T", _tonal(13, 512 + 23 * cfg.hop + 99, nf)),
        ("leading axes", rng.integers(-32768, 32768,
                                      (2, 3, 512 + 5 * cfg.hop + 1))),
        ("wide int32", rng.integers(-2 ** 31, 2 ** 31,
                                    (3, 512 + 40 * cfg.hop + 7))),
        ("beyond the resident warps", _tonal(61, 16000 + 3, nf + 1)),
    ]
    for name, x in inputs:
        x = x.astype(np.int32 if name == "wide int32" else np.int16)
        xt = torch.from_numpy(x).to(dev)
        F = cfg.n_frames(x.shape[-1])
        for key, fn, plain in (
                ("K2", int_fused.mfcc_int_fused,
                 int_fused.mfcc_int_fused_plain),
                ("K9", int_fused.mfcc_int_v2, int_fused.mfcc_int_fused_plain),
                ("K3-v1", int_fused.mfcc_int_v1, int_fused.mfcc_int_v1_plain)):
            want_n = dict(int_fused.LAUNCHES)
            want_n[key] += 1
            got = fn(xt, cfg)
            torch.cuda.synchronize()
            assert int_fused.LAUNCHES == want_n, (key, name)
            assert got.shape == x.shape[:-1] + (F, nf), (key, name)
            assert torch.equal(got, plain(xt, cfg)), (key, name)


def test_int_epilogue_refuses_unaligned_rows(dev):
    """K10's epilogue reads its rows in 16-byte words: power whose data
    starts off a 16-byte boundary raises, and nothing is launched."""
    power = torch.zeros(2 * 256 + 1, dtype=torch.int32, device=dev)
    before = dict(int_fused.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        int_fused.mfcc_int_epi(power[1:].reshape(2, 256))
    assert int_fused.LAUNCHES == before


INT32_EDGES = (2 ** 31 - 1, -(2 ** 31 - 1), -2 ** 31)


def test_int_v1_kernel_on_card(dev):
    """K3-v1 is one launch of K2's audio kernel a call (K3's count does not
    move), equal to its plain version on int16, on full-range int32, on
    int32 edges +-(2^31 - 1) and -2^31 among full-range samples (where
    the emphasis wraps mod 2^32; equal to ``int_ref`` there) and on int64
    input with two leading axes; equal to K2 on int16 and off it on
    full-range int32 and int64.  On
    int16 and int32 a call allocates its output and nothing else (1 MB
    of slack)."""
    rng = np.random.default_rng(21)
    T = 512 + 40 * 170 + 77
    edges = np.array(INT32_EDGES, np.int64)[rng.integers(0, 3, (3, T))]
    wild = rng.random(edges.shape) < 0.25
    edges[wild] = rng.integers(-2 ** 31, 2 ** 31, int(wild.sum()))
    edges[:, :3] = INT32_EDGES
    inputs = [
        ("int16", _tonal(5, T, 21).astype(np.int16)),
        ("int32", rng.integers(-2 ** 31, 2 ** 31, (4, T)).astype(np.int32)),
        ("int32 edges", edges.astype(np.int32)),
        ("int64", rng.integers(-2 ** 31, 2 ** 31, (2, 3, T))),
    ]
    int_fused.mfcc_int_v1(torch.from_numpy(inputs[0][1]).to(dev))  # warm
    for name, x in inputs:
        xt = torch.from_numpy(x).to(dev)
        want_n = dict(int_fused.LAUNCHES)
        want_n["K3-v1"] += 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        got = int_fused.mfcc_int_v1(xt)
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_allocated(dev) - base
        assert int_fused.LAUNCHES == want_n, name
        assert got.shape == x.shape[:-1] + (MFCCConfig().n_frames(T), 32)
        if x.dtype != np.int64:
            assert grown <= got.nbytes + 2 ** 20, (name, grown)
        assert torch.equal(got, int_fused.mfcc_int_v1_plain(xt)), name
        k2 = int_fused.mfcc_int_fused(xt.reshape(-1, T).to(torch.int32))
        if name in ("int16", "int32", "int64"):
            assert torch.equal(got.reshape(k2.shape), k2) == (name == "int16")
        if name == "int32 edges":
            want = np.stack([int_ref.mfcc_int(s) for s in edges])
            assert np.array_equal(got.cpu().numpy(), want)


# -- the FP64 product engine (K5, K5-frames, K4-split, K8) --------------------------

def test_engine_ragged_tiles_match_plain(dev):
    """K8 on 3 streams x 1 s (9 tiles) and on a stream of 4 frames, shorter
    than a tile; K5 and K5-frames on 5 streams x 4 frames (one ragged tile
    of the flattened frames) and 3 x 1 s; the split-DFT step on 3 streams;
    each within its tolerance of the plain version."""
    cfg = MFCCConfig()
    for S, T in ((3, 16000), (1, 512 + 3 * 170)):
        x = torch.from_numpy(_tonal(S, T, seed=T).astype(np.int16)).to(dev)
        for name in ("mfcc_raw", "mfcc_batch_dense", "mfcc_emphasized"):
            xin = _dense_input(name, x)
            got = getattr(dense_fused, name)(xin, cfg)
            want = getattr(dense_fused, name + "_plain")(xin, cfg)
            assert (got - want).abs().max().item() <= TOL, (name, S, T)
    for S, T in ((5, 512 + 3 * 170), (3, 16000)):
        x = torch.from_numpy(_tonal(S, T, seed=S).astype(np.int16)).to(dev)
        for passes in (3, 6):
            got = float_fused.mfcc_radix2(x, cfg, dft_passes=passes)
            want = float_fused.mfcc_radix2_plain(x, cfg, dft_passes=passes)
            assert (got - want).abs().max().item() <= TOL_R2, (S, T, passes)
        fr = framing.extract_frames(framing.preemphasis(x.float()), 512,
                                    cfg.hop)
        got = float_fused.mfcc_frames_float(fr, cfg, dft_passes=3)
        want = float_fused.mfcc_frames_float_plain(fr, cfg, dft_passes=3)
        assert (got - want).abs().max().item() <= TOL_R2
    before = stream_fused.LAUNCHES["K4-split"]
    _k4_run(dev, False, 3, 1024, cfg, seed=1, dft_passes=3)
    assert stream_fused.LAUNCHES["K4-split"] == before + 4


@pytest.mark.parametrize("passes", [3, 6])
def test_engine_follows_in_place_edits(dev, passes):
    """K5 and K5-frames with caller-given operators whose mel and dft are
    edited in place between two calls: the second call's output follows
    the edit (the plain version on the edited operators), not the first
    call's cached tables."""
    cfg = MFCCConfig()
    d = float_fused.default_operators(cfg, dev)
    ops = d._replace(dft=d.dft.clone(), mel=d.mel.clone())
    x = torch.from_numpy(_tonal(2, 8000, seed=7).astype(np.int16)).to(dev)
    fr = framing.extract_frames(framing.preemphasis(x.float()), 512, cfg.hop)
    for _ in range(2):
        for kern, plain, xin in (
                (float_fused.mfcc_radix2, float_fused.mfcc_radix2_plain, x),
                (float_fused.mfcc_frames_float,
                 float_fused.mfcc_frames_float_plain, fr)):
            got = kern(xin, cfg, dft_passes=passes, operators=ops)
            want = plain(xin, cfg, dft_passes=passes, operators=ops)
            assert (got - want).abs().max().item() <= TOL_R2
        ops.mel.mul_(0.25)
        ops.dft[:, 3].mul_(-1.0)


def test_engine_refusal_raises(dev, monkeypatch):
    """A launch the C entry point refuses (here an operator whose chunks
    are not a whole number of MMA steps) raises; nothing falls back to the
    plain version and no launch is counted."""
    monkeypatch.setattr(
        dmma_product.Operator, "args",
        lambda self: (self.data.data_ptr(), self.rows, self.chunk_rows + 1))
    cfg = MFCCConfig()
    x = torch.from_numpy(_tonal(2, 4000, seed=5).astype(np.int16)).to(dev)
    fr = framing.extract_frames(framing.preemphasis(x.float()), 512, cfg.hop)
    calls = [lambda: dense_fused.mfcc_raw(x, cfg),
             lambda: float_fused.mfcc_radix2(x, cfg, dft_passes=3),
             lambda: float_fused.mfcc_frames_float(fr, cfg, dft_passes=6)]
    before = (dict(dense_fused.LAUNCHES), dict(float_fused.LAUNCHES))
    for call in calls:
        with pytest.raises(RuntimeError, match="launch failed"):
            call()
    sm = StreamingMFCC(precision="fast")
    state = sm.init(2)
    with pytest.raises(RuntimeError, match="launch failed"):
        sm.step(x[:, :1024].contiguous(), state)
    assert (dict(dense_fused.LAUNCHES), dict(float_fused.LAUNCHES)) == before


# -- parallel/ on the card: world size 1 on NCCL, the models ----------------------

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A world of one NCCL rank on card 0 in this process, and its mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist
    from mfcc_tpu_torch.parallel import bootstrap, make_mesh
    store = tmp_path_factory.mktemp("group") / "store"
    bootstrap.init_group(0, 1, str(store), timeout=120)    # NCCL, the card
    assert dist.get_backend() == "nccl"
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("int_path", [False, True], ids=["float", "int"])
def test_sharded_batch_nccl_world_one(dev, nccl_mesh, int_path):
    """The kernel route at world size 1 on NCCL: one K1 / K2 launch, the
    cepstra those of the unsharded module bit for bit, the energy (an
    all-reduce on the card) within 1e-6 of the unsharded mean c0^2."""
    from mfcc_tpu_torch.parallel import gather, mfcc_sharded_fn, shard_streams
    cfg = MFCCConfig()
    audio = torch.from_numpy(_tonal(8, 16000, seed=21).astype(
        np.int16)).to(dev)
    fn = mfcc_sharded_fn(nccl_mesh, cfg, int_path=int_path)
    assert fn.selected_impl == "kernel/all-ranks"
    counts = (fladder.LAUNCHES, dict(int_fused.LAUNCHES))
    cep, energy = fn(shard_streams(audio, nccl_mesh))
    torch.cuda.synchronize()
    if int_path:
        assert int_fused.LAUNCHES["K2"] == counts[1]["K2"] + 1
        want = MFCC().int(audio)
    else:
        assert fladder.LAUNCHES == counts[0] + 1
        want = MFCC()(audio)
    assert torch.equal(gather(cep, nccl_mesh, fn.layout), want)
    e_want = float((want[..., 0].float() ** 2).mean())
    assert energy.device == dev
    assert abs(float(energy) - e_want) <= 1e-6 * e_want


@pytest.mark.parametrize("int_path", [False, True], ids=["float", "int"])
def test_sharded_streaming_nccl_world_one(dev, nccl_mesh, int_path):
    """Sharded streaming at world size 1: one K4 launch a full-chunk step,
    the mask, features and every carry those of ``StreamingMFCC``; a flush
    step takes the chain."""
    from mfcc_tpu_torch.parallel import (shard_rows, shard_state,
                                         streaming_sharded_fn)
    S, C = 130, 1024
    sig = _tonal(S, 5 * C, seed=22).astype(np.int16)
    step = streaming_sharded_fn(nccl_mesh, MFCCConfig(), int_path=int_path)
    assert step.selected_impl == "fused-stream-kernel/dp"
    sm = StreamingMFCC(int_path=int_path)
    state, ref = shard_state(sm.init(S), nccl_mesh), sm.init(S)
    key = "K4-INT" if int_path else "K4-float"
    for k in range(4):
        chunk = torch.from_numpy(sig[:, k * C:(k + 1) * C]).to(dev)
        reset = torch.from_numpy(np.arange(S) % 3 == k % 3).to(dev)
        before = stream_fused.LAUNCHES[key]
        feats, mask, state = step(shard_rows(chunk, nccl_mesh), state, reset)
        assert stream_fused.LAUNCHES[key] == before + 1
        rf, rm, ref = sm.step(chunk, ref, reset)
        assert torch.equal(mask, rm) and torch.equal(feats[rm], rf[rm])
        for a, b in zip(state, ref):
            assert torch.equal(a, b)
    tail = torch.from_numpy(sig[:, 4 * C:]).to(dev)
    lengths = torch.full((S,), 300, dtype=torch.int32, device=dev)
    feats, mask, state = step(tail, state, None, lengths)
    rf, rm, ref = sm.step(tail, ref, None, lengths)
    assert torch.equal(mask, rm) and torch.equal(feats[rm], rf[rm])


def test_sharded_halo_nccl_world_one(dev, nccl_mesh):
    """The INT halo launches K3 once and equals ``MFCC().int`` on the
    padded signal; the float halo is the chain on the same frame rows (the
    zero-extended signal's T/hop rows) bit for bit, NaN where the chain
    is NaN (a row wholly in the zero padding: log2 0 = -inf through the
    DCT; ``torch.equal`` is false on any NaN), and within GATE of the
    oracle.  (Against the chain on the n_frames rows alone it reads up to
    2e-4 on the card: cuBLAS sums a block of other rows in another order,
    and log2 amplifies that in quiet mel bands.)"""
    from mfcc_tpu_torch.parallel import (mfcc_halo_fn, pad_for_halo,
                                         shard_streams)
    cfg = MFCCConfig()
    T = 16000
    Tp = pad_for_halo(T, nccl_mesh, cfg)
    audio = torch.from_numpy(np.pad(_tonal(4, T, seed=23), (
        (0, 0), (0, Tp - T))).astype(np.int16)).to(dev)
    x = shard_streams(audio, nccl_mesh)
    before = int_fused.LAUNCHES["K3"]
    out = mfcc_halo_fn(nccl_mesh, cfg, int_path=True)(x)
    assert int_fused.LAUNCHES["K3"] == before + 1
    F = cfg.n_frames(Tp)
    assert out.shape == (4, Tp // cfg.hop, 32)
    assert torch.equal(out[:, :F], MFCC().int(audio))
    fout = mfcc_halo_fn(nccl_mesh, cfg)(x)
    emph = framing.preemphasis(audio.to(torch.float32))
    emph = torch.cat([emph, emph.new_zeros(4, cfg.nfft - cfg.hop)], dim=1)
    frames = framing.extract_frames(emph, cfg.nfft, cfg.hop)
    want = float_ops.mfcc_frames(frames[:, : Tp // cfg.hop].contiguous(),
                                 cfg)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(fout), nan)
    assert torch.equal(fout[~nan], want[~nan])
    for s in range(4):
        want = float_ref.mfcc_float(audio[s].cpu().numpy(), cfg)
        assert np.abs(fout[s, :F].cpu().numpy() - want).max() <= GATE


def test_sharded_auto_routing_on_card(dev, nccl_mesh):
    """"auto" takes the kernels on the card (the JAX package's Mosaic
    route on a TPU): an odd hop K6 once, bit for bit
    ``MFCC(MFCCConfig(step=171))``; the chain for a config outside the
    family."""
    from mfcc_tpu_torch.parallel import (gather, mfcc_sharded_fn,
                                         shard_streams, streaming_sharded_fn)
    assert mfcc_sharded_fn(nccl_mesh).selected_impl == "kernel/all-ranks"
    assert mfcc_sharded_fn(nccl_mesh, int_path=True).selected_impl == \
        "kernel/all-ranks"
    odd = MFCCConfig(step=171)
    fn = mfcc_sharded_fn(nccl_mesh, odd)
    assert fn.selected_impl == "kernel/all-ranks"
    audio = torch.from_numpy(_tonal(8, 16000, seed=26).astype(
        np.int16)).to(dev)
    before = (fladder.LAUNCHES, float_fused.LAUNCHES["K6"])
    cep, _ = fn(shard_streams(audio, nccl_mesh))
    torch.cuda.synchronize()
    assert (fladder.LAUNCHES, float_fused.LAUNCHES["K6"]) == \
        (before[0], before[1] + 1)
    assert torch.equal(gather(cep, nccl_mesh, fn.layout), MFCC(odd)(audio))
    assert mfcc_sharded_fn(nccl_mesh, MFCCConfig(
        step=160, window_samples=400)).selected_impl == "chain/dp-sp"
    assert mfcc_sharded_fn(nccl_mesh, use_kernels=False).selected_impl == \
        "chain/dp-sp"
    assert streaming_sharded_fn(nccl_mesh, use_kernels=False).selected_impl \
        == "chain-step/dp"


def test_int_features_model_on_card(dev):
    """``IntMFCCFeatures()`` lands on the card and runs K2: equal to the
    RTL oracle."""
    from mfcc_tpu_torch.models import IntMFCCFeatures
    sig = _tonal(3, 4000, seed=24).astype(np.int16)
    model = IntMFCCFeatures()
    assert model.mfcc.window.device.type == "cuda"
    before = int_fused.LAUNCHES["K2"]
    got = model(torch.from_numpy(sig).to(dev))
    assert int_fused.LAUNCHES["K2"] == before + 1
    for s in range(3):
        assert np.array_equal(got[s].cpu().numpy(), int_ref.mfcc_int(
            sig[s].astype(np.int64)))


def test_float_models_on_card(dev):
    """The float models on the card: within 1e-4 of the CPU's (two f32
    DFT-matmul chains, cuBLAS's sums against the CPU's, the bound the CPU
    tests hold the port and JAX to), and gradients to the audio, finite."""
    from mfcc_tpu_torch.models import MFCCFeatures, LogMelSpectrogram
    sig = _tonal(2, 4000, seed=25).astype(np.float32)
    for cls in (MFCCFeatures, LogMelSpectrogram):
        x = torch.from_numpy(sig).to(dev).requires_grad_(True)
        out = cls(mel_floor=1e-6)(x)
        want = cls(mel_floor=1e-6, device="cpu")(torch.from_numpy(sig))
        assert (out.detach().cpu() - want).abs().max() <= 1e-4
        (g,) = torch.autograd.grad(out.sum(), x)
        assert torch.isfinite(g).all() and g.abs().max() > 0


def test_cli_convert_and_stream_on_card(dev, tmp_path, capsys):
    """The command line on the card: ``convert`` is one K2 launch a batch
    with the CPU's bytes; ``stream`` one K4 launch a full chunk and one K3
    a flushed INT chunk, with the CPU's bytes."""
    from scipy.io import wavfile
    from mfcc_tpu_torch import cli
    from mfcc_tpu_torch.io import transport
    sig = _tonal(3, 9000, seed=26).astype(np.int16)
    for root in (tmp_path / "card", tmp_path / "cpu"):
        root.mkdir()
        for i in range(3):
            wavfile.write(str(root / f"{i}.wav"), 16000, sig[i][: 9000 - i])
    before = int_fused.LAUNCHES["K2"]
    assert cli.main(["convert", str(tmp_path / "card")]) == 0
    assert int_fused.LAUNCHES["K2"] == before + 1
    assert cli.main(["convert", str(tmp_path / "cpu"), "--backend",
                     "cpu"]) == 0
    for i in range(3):
        assert ((tmp_path / "card" / f"{i}.mfcc").read_bytes()
                == (tmp_path / "cpu" / f"{i}.mfcc").read_bytes())
    words = tmp_path / "w.bin"
    words.write_bytes(transport.encode_stream(sig[0]).astype("<u4")
                      .tobytes())
    k4, k3 = stream_fused.LAUNCHES["K4-INT"], int_fused.LAUNCHES["K3"]
    assert cli.main(["stream", str(words), str(tmp_path / "card.bin")]) == 0
    assert stream_fused.LAUNCHES["K4-INT"] == k4 + 9000 // 1024
    assert int_fused.LAUNCHES["K3"] == k3 + 1
    assert cli.main(["stream", str(words), str(tmp_path / "cpu.bin"),
                     "--backend", "cpu"]) == 0
    assert ((tmp_path / "card.bin").read_bytes()
            == (tmp_path / "cpu.bin").read_bytes())


def test_cli_selftest_on_card(dev, capsys):
    from mfcc_tpu_torch import cli
    assert cli.main(["selftest"]) == 0
    out = capsys.readouterr().out
    assert "fused INT kernel (K2) bit-exact vs its plain version: PASS" in out
    assert out.strip().splitlines()[-1] == "SELFTEST PASS"


@pytest.mark.parametrize("precision", ["high", "default", "bf16"])
def test_limb_precisions_on_card(dev, precision):
    """``"high"``, ``"default"`` and ``"bf16"`` on CUDA tensors take the
    limb passes: the card's products on the same operands within 1e-6 of
    the CPU's; the chain finite and near the CPU's limb chain: within a
    hundredth of its distance from the f32 chain, or twice the f32 chain's
    own card-to-CPU distance plus TOL (each product sums in another order
    on the card), whichever is larger."""
    passes = float_ops.LIMB_PASSES[precision]
    rng = np.random.default_rng(27)
    x = torch.from_numpy(rng.standard_normal((256, 512)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((512, 514)).astype(np.float32))
    want = float_ops.limb_matmul(x, w, passes)
    got = float_ops.limb_matmul(x.to(dev), w.to(dev), passes).cpu()
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    sig = torch.from_numpy(_tonal(2, 8000, seed=28))
    out = MFCC(precision=precision)(sig.to(dev)).cpu()
    assert torch.isfinite(out).all()
    cpu = float_ops.mfcc_batch(sig, precision=precision, limbs=passes)
    f32 = float_ops.mfcc_batch(sig.to(dev)).cpu()
    f32_gap = (f32 - float_ops.mfcc_batch(sig)).abs().max()
    limit = max(0.01 * (out - f32).abs().max(), 2 * f32_gap + TOL)
    assert (out - cpu).abs().max() <= limit
