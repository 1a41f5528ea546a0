"""Kaldi's recipe (``KaldiConfig``, conf/mfcc_hires.conf) on the port: the
plain reference ``ref/kaldi_ref.py`` against the recipe's anchors, the
port's tables, plain K1 version and module against the reference (the
FLT_EPSILON floor exercised by a constant stretch), the per-frame DC
removal and emphasis against Kaldi's literal loop, streaming chunked equal
to batch, the INT entries refusing the recipe, and the benchmark's
``kaldi.batch`` cell (its frozen reference, its driver, its control and
the faults its comparison has to catch) on the CPU at tiny sizes.  Tests
marked ``cuda`` run K1's Kaldi instantiation on the card and skip without
one.  Nothing here imports JAX or ``mfcc_tpu``."""

import ast
import hashlib
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mfcc_tpu_torch import MFCC, MFCCConfig, StreamingMFCC, tables
from mfcc_tpu_torch.config import KALDI_MFCC_HIRES, KaldiConfig
from mfcc_tpu_torch.ops import fladder, framing
from mfcc_tpu_torch.ref import kaldi_ref

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GATE = 5e-4           # the configuration's limit against the reference
HIRES = dict(num_mel_bins=40, num_ceps=40, low_freq=20, high_freq=-400,
             dither=0, use_energy=False)
LN_EPS = math.log(np.finfo(np.float32).eps)       # -15.9424


@pytest.fixture(scope="module")
def opts():
    return kaldi_ref.options(**HIRES)


def _speech_like(S, T, seed, flat=None):
    """The benchmark's signal shape (chirp, tone, noise) as int16, with
    ``flat`` = (start, stop) held at a constant value in stream 0: after DC
    removal its frames carry no energy, so their mel energies floor."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000.0
    base = (9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
            + 4000 * np.sin(2 * np.pi * 900 * t))
    x = np.clip(np.round(base[None] + rng.integers(-1500, 1500, (S, T))),
                -32768, 32767).astype(np.int16)
    if flat is not None:
        x[0, flat[0]: flat[1]] = 1234
    return x


# -- the reference against the recipe's anchors ---------------------------------

def test_reference_anchors(opts):
    L, shift, N = kaldi_ref.geometry(opts)
    assert (L, shift, N) == (400, 160, 512)
    lo, hi = kaldi_ref.mel_scale(20.0), kaldi_ref.mel_scale(7600.0)
    assert abs((hi - lo) / 41 - 67.2011) < 1e-4
    W = kaldi_ref.mel_banks(opts)
    assert W.shape == (256, 40)
    nz = (W != 0).numpy()
    band = [(int(np.argmax(nz[:, b])), 256 - int(np.argmax(nz[::-1, b])))
            for b in range(40)]
    assert band[0] == (1, 4) and band[1] == (3, 6)
    assert band[38] == (200, 228) and band[39] == (214, 244)
    assert nz.sum() == 468 and max(h - l for l, h in band) == 30
    assert kaldi_ref.num_frames(63_922, opts) == 398
    assert kaldi_ref.num_frames(399, opts) == 0
    lift = kaldi_ref.lifter(opts)
    assert float(lift.max()) == pytest.approx(12.0) and int(lift.argmax()) == 11
    win = kaldi_ref.povey_window(400)
    assert float(win[0]) == 0.0 and float(win.max()) <= 1.0
    from perfbench import kaldi_roofline
    assert kaldi_roofline.ops_per_frame(opts) == 21_321
    assert kaldi_roofline.least_s(opts, 1024, 63_922) == pytest.approx(
        1024 * 398 * 21_321 / 67e12)
    import sys
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    band = fladder.default_operators(KALDI_MFCC_HIRES, CPU).band
    assert chip_smoke.kaldi_ops_per_frame(KALDI_MFCC_HIRES, band) == 21_321


@pytest.mark.parametrize("given", [
    {},                                        # Kaldi's defaults dither
    {"dither": 0.0, "use_energy": False, "window_type": "hamming"},
    {"dither": 0.0, "use_energy": False, "num_bins": 40}])
def test_reference_refuses_what_it_does_not_compute(given):
    with pytest.raises(ValueError):
        kaldi_ref.options(**given)


def test_port_tables_are_the_references(opts):
    cfg = KALDI_MFCC_HIRES
    win, mel, dct = fladder.kaldi_operators(cfg)
    np.testing.assert_allclose(win[:400], kaldi_ref.povey_window(400).numpy(),
                               rtol=0, atol=1e-15)
    assert not win[400:].any()
    np.testing.assert_allclose(mel, kaldi_ref.mel_banks(opts).numpy(),
                               rtol=0, atol=1e-12)
    assert np.array_equal(mel != 0, kaldi_ref.mel_banks(opts).numpy() != 0)
    want = (kaldi_ref.dct_matrix(opts).T * kaldi_ref.lifter(opts)).numpy()
    np.testing.assert_allclose(dct / math.log(2.0), want, rtol=0,
                               atol=1e-12)
    assert tables.FLT_EPSILON == kaldi_ref.FLT_EPSILON


def test_config_fields_and_validation():
    cfg = KaldiConfig()
    assert cfg == KALDI_MFCC_HIRES and cfg.recipe == "kaldi"
    assert MFCCConfig().recipe == "fpga" and cfg != MFCCConfig()
    assert (cfg.low_freq, cfg.preemphasis_coefficient,
            cfg.cepstral_lifter) == (20.0, 0.97, 22.0)
    with pytest.raises(TypeError):             # constants of the recipe
        KaldiConfig(cepstral_lifter=0.0)
    assert (cfg.windowlen, cfg.hop, cfg.nfft) == (400, 160, 512)
    assert cfg.n_frames(63_922) == 398
    for bad in ({"nfft": 1024}, {"nceptrums": 41}, {"high_freq": -7990.0},
                {"window_samples": None}):
        with pytest.raises(ValueError):
            KaldiConfig(**bad)
    # an 8 kHz variant: 200 samples padded to 256
    assert KaldiConfig(samplerate=8000, nfft=256, window_samples=200,
                       step=80, nfilters=23, nceptrums=13,
                       high_freq=-200.0).nfft == 256


# -- step 3's algebra -----------------------------------------------------------

def _literal(frame: np.ndarray, c: float) -> np.ndarray:
    """feature-window.cc: ``window->Add(-window->Sum() / frame_length)``
    then ``Preemphasize``, as Kaldi's loops run."""
    w = frame.astype(np.float64).copy()
    w -= w.sum() / len(w)
    for i in range(len(w) - 1, 0, -1):
        w[i] -= c * w[i - 1]
    w[0] -= c * w[0]
    return w


@pytest.mark.parametrize("c", [0.97, 0.5, 0.0])
def test_dc_and_emphasis_algebra_is_the_literal_loop(c):
    x = _speech_like(1, 400 * 6, seed=3)[0].reshape(6, 400)
    x[2] = 77                                  # a constant frame
    got = framing.kaldi_preemphasis(torch.from_numpy(x).double(), c).numpy()
    for f in range(6):
        np.testing.assert_allclose(got[f], _literal(x[f], c), rtol=0,
                                   atol=1e-9)
    assert np.abs(got[2]).max() < 1e-9


# -- the port against the reference ---------------------------------------------

@pytest.mark.parametrize("S,T,flat", [(2, 4000, (800, 2000)),
                                      (3, 400, None), (1, 5123, (0, 700))])
def test_plain_and_module_match_the_reference(opts, S, T, flat):
    x = torch.from_numpy(_speech_like(S, T, seed=T, flat=flat))
    want = kaldi_ref.mfcc(x, opts)
    plain = fladder.mfcc_kaldi_ladder_plain(x, KALDI_MFCC_HIRES)
    module = MFCC(KALDI_MFCC_HIRES, device="cpu")(x)
    wrapper = fladder.mfcc_kaldi_ladder(x, KALDI_MFCC_HIRES)
    assert plain.shape == module.shape == want.shape == (
        S, kaldi_ref.num_frames(T, opts), 40)
    assert plain.dtype == module.dtype == torch.float32
    for got in (plain, module, wrapper):
        assert torch.isfinite(got).all()
        assert (got.double() - want).abs().max().item() <= 2e-5
    if flat is not None:
        # a frame wholly inside the stretch: every mel energy at the floor,
        # so c0 = sqrt(40) ln(FLT_EPSILON) and the rest vanish
        f = -(-flat[0] // 160)
        assert 160 * f + 400 <= flat[1]
        assert want[0, f, 0].item() == pytest.approx(math.sqrt(40) * LN_EPS)
        assert module[0, f, 0].item() == pytest.approx(
            math.sqrt(40) * LN_EPS, abs=1e-4)
        assert module[0, f, 1:].abs().max().item() < 1e-4


def test_module_frames_and_leading_axes(opts):
    x = torch.from_numpy(_speech_like(4, 2400, seed=9))
    fe = MFCC(KALDI_MFCC_HIRES, device="cpu")
    full = fe(x)
    assert torch.equal(fe(x.reshape(2, 2, -1)), full.reshape(2, 2, 13, 40))
    frames = framing.extract_frames(x.float(), 512, 160, 400)
    assert torch.equal(fe.frames(frames), full)
    fe2 = MFCC(KALDI_MFCC_HIRES, device="cpu")
    fe2.load_state_dict(fe.state_dict())
    assert torch.equal(fe2(x), full)


def test_int_entries_and_other_dials_raise():
    fe = MFCC(KALDI_MFCC_HIRES, device="cpu")
    x = np.zeros((1, 1000), np.int16)
    with pytest.raises(ValueError, match="no INT path"):
        fe.int(x)
    with pytest.raises(ValueError, match="no INT path"):
        fe.int_frames(np.zeros((1, 2, 512), np.int16))
    for kw in ({"precision": "fast"}, {"mel_floor": 1.0},
               {"method": "rfft"}, {"dtype": torch.float64}):
        with pytest.raises(ValueError):
            MFCC(KALDI_MFCC_HIRES, device="cpu", **kw)
    with pytest.raises(ValueError):
        StreamingMFCC(KALDI_MFCC_HIRES, int_path=True, device="cpu")


@pytest.mark.parametrize("C", [160, 399, 1024])
def test_streaming_chunked_equals_batch(C):
    x = _speech_like(2, 5000, seed=C, flat=(1000, 1900))
    want = MFCC(KALDI_MFCC_HIRES, device="cpu")(torch.from_numpy(x)).numpy()
    sm = StreamingMFCC(KALDI_MFCC_HIRES, device="cpu")
    got, state = sm.process(x, C)
    assert state.buffer.shape == (2, 399)
    for s in range(2):
        assert got[s].shape == want[s].shape
        np.testing.assert_array_equal(got[s], want[s])


# -- the benchmark's cell ---------------------------------------------------------

TINY = {"kaldi.batch": {"streams": 3, "samples": 2000,
                        "trace_seconds": 0.2},
        "int.stream": {"streams": 4, "ring_chunks": 6, "keep": 2,
                       "trace_seconds": 0.2}}


@pytest.fixture(scope="module")
def bench():
    from perfbench import harness
    return harness.load_benchmark()


@pytest.fixture(autouse=True)
def _only_new_modules_forbidden(monkeypatch):
    """The harness refuses a run once JAX is loaded; other test files may
    have loaded it in this process before, so a run here is held to the
    modules that it loads itself (the imports of the new files are checked
    apart, below)."""
    import sys
    from perfbench import harness
    before = {m.split(".")[0] for m in sys.modules}
    monkeypatch.setattr(harness, "forbidden_modules", lambda: sorted(
        ({m.split(".")[0] for m in sys.modules} - before)
        & set(harness.FORBIDDEN)))


def _run(bench, workload, trace=False, seed=2**33 + 7):
    from perfbench import harness
    return harness.run_cell(bench, workload, seed, 0.4, trace, CPU,
                            time.perf_counter(), TINY[workload])


def test_frozen_reference_is_the_ports():
    assert (ROOT / "perfbench/ref/kaldi_ref.py").read_bytes() == \
        (ROOT / "mfcc_tpu_torch/ref/kaldi_ref.py").read_bytes()


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("rel", ["perfbench/ref/kaldi_ref.py",
                                 "mfcc_tpu_torch/ref/kaldi_ref.py",
                                 "perfbench/drivers/recipe_batch.py",
                                 "perfbench/kaldi_roofline.py",
                                 "perfbench/recipe_control.py",
                                 "perfbench/metrics/module.launches_per_call.py"])
def test_new_benchmark_files_import_no_jax(rel):
    names = _imports(ROOT / rel)
    assert not names & {"jax", "jaxlib", "mfcc_tpu"}
    if "ref/" in rel:
        assert names <= {"__future__", "math", "torch"}


def test_configuration_agrees_with_its_options(bench, opts):
    from perfbench import harness
    cell, conf = harness.find_cell(bench, "kaldi.batch")
    config = harness.read_json(ROOT / conf["file"])
    assert conf["reduced"] == [] and cell["chips"] == 1
    cfg = KaldiConfig(**config["mfcc"])
    assert cfg == KALDI_MFCC_HIRES
    o = kaldi_ref.options(**config["kaldi"])
    assert o == opts
    assert kaldi_ref.geometry(o) == (cfg.windowlen, cfg.hop, cfg.nfft)
    assert config["limit"] == GATE and len(conf["source"]) <= 200


@pytest.mark.parametrize("workload", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_new_cells_run_tiny(bench, workload, trace):
    from perfbench import harness
    res = _run(bench, workload, trace)
    assert res["correct"], res["checks"]
    wanted = {m["name"] for m in harness.cell_metrics(bench, workload, trace)}
    if trace:
        assert set(res["metrics"]) <= wanted
        if workload == "kaldi.batch":       # the plain version: no launch
            assert res["metrics"]["module.launches_per_call"]["value"] == 0
    else:
        assert set(res["metrics"]) == wanted
    for name in wanted:
        from perfbench import harness as h
        if trace:
            assert h.load_reader(name)({}) is None


def _with_fault(monkeypatch, fault):
    """Plant ``fault`` in the recipe's plain version (the CPU route)."""
    frames_plain = fladder.mfcc_kaldi_frames_plain

    def emphasis_across_frames(audio, cfg, operators=None):
        # the stream emphasized before framing (each frame's first sample
        # from the sample before it), then each frame's mean removed: the
        # FPGA recipe's order
        x = audio.to(torch.float64)
        c = cfg.preemphasis_coefficient
        e = x - c * torch.cat([x[..., :1], x[..., :-1]], dim=-1)
        fr = framing.extract_frames(e, cfg.windowlen, cfg.hop)
        y = fr - fr.mean(dim=-1, keepdim=True)
        y = torch.nn.functional.pad(y, (0, cfg.nfft - cfg.windowlen))
        return fladder.ladder_tail_plain(
            y, fladder.default_operators(cfg, x.device), cfg,
            tables.FLT_EPSILON)

    def stale_mean(frames, coeff):
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        mu = frames.mean(dim=-1, keepdim=True)
        stale = torch.cat([mu[..., :1, :], mu[..., :-1, :]], dim=-2)
        return (frames - coeff * prev) - (1.0 - coeff) * stale

    def hamming(cfg):
        win, mel, dct = fladder_kaldi_operators(cfg)
        win = np.zeros_like(win)
        win[: cfg.windowlen] = np.hamming(cfg.windowlen)
        return win, mel, dct

    fladder_kaldi_operators = fladder.kaldi_operators
    if fault == "stale mean":
        monkeypatch.setattr(framing, "kaldi_preemphasis", stale_mean)
    elif fault == "emphasis across frames":
        monkeypatch.setattr(fladder, "mfcc_kaldi_ladder_plain",
                            emphasis_across_frames)
    else:
        monkeypatch.setattr(fladder, "kaldi_operators", hamming)
    assert frames_plain is fladder.mfcc_kaldi_frames_plain


@pytest.mark.parametrize("fault", ["stale mean", "emphasis across frames",
                                   "hamming for povey"])
def test_the_cells_comparison_catches_planted_faults(bench, monkeypatch,
                                                     fault):
    _with_fault(monkeypatch, fault)
    res = _run(bench, "kaldi.batch", seed=2**35 + 1)
    assert not res["correct"]
    assert res["checks"]["max_abs_err"]["value"] > 100 * GATE


def test_the_control_is_not_correct(bench):
    from perfbench import recipe_control
    checks = recipe_control.readings(bench, "kaldi.batch", 2**32 + 9, 1.0,
                                     CPU, TINY["kaldi.batch"])
    assert not all(c.ok for c in checks)
    by = {c.name: c.value for c in checks}
    assert by["max_abs_err"] > 10 * GATE and by["nonfinite_off"] == 0


def test_the_parent_program_refuses_the_recipe_at_once(bench, monkeypatch):
    """A program without ``KaldiConfig`` fails the cell before any timing
    (an ImportError in the driver), not with a wrong answer."""
    import mfcc_tpu_torch.config as config
    monkeypatch.delattr(config, "KaldiConfig")
    with pytest.raises(ImportError):
        _run(bench, "kaldi.batch")


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_kernel_matches_plain_and_reference(dev, opts):
    cfg = KALDI_MFCC_HIRES
    for S, T in ((3, 400), (5, 400 + 160 * 7 + 5), (2, 9000), (64, 63_922)):
        x16 = torch.from_numpy(_speech_like(S, T, seed=T,
                                            flat=(160, 1600))).to(dev)
        before = fladder.KALDI_LAUNCHES, fladder.LAUNCHES
        got = MFCC(cfg, device=dev)(x16)
        torch.cuda.synchronize()
        assert (fladder.KALDI_LAUNCHES, fladder.LAUNCHES) == (
            before[0] + 1, before[1])
        assert got.shape == (S, cfg.n_frames(T), 40)
        want = kaldi_ref.mfcc(x16, opts)
        assert torch.isfinite(got).all()
        assert (got.double() - want).abs().max().item() <= 2e-5
        plain = fladder.mfcc_kaldi_ladder_plain(x16, cfg)
        assert (got - plain).abs().max().item() <= 2e-5
        f32 = fladder.mfcc_kaldi_ladder(x16.float(), cfg)
        assert torch.equal(f32, got)


@pytest.mark.cuda
def test_card_frames_and_streaming_equal_batch(dev):
    cfg = KALDI_MFCC_HIRES
    x = torch.from_numpy(_speech_like(3, 6000, seed=5)).to(dev)
    fe = MFCC(cfg, device=dev)
    full = fe(x)
    frames = framing.extract_frames(x.float(), 512, 160, 400).contiguous()
    assert torch.equal(fe.frames(frames), full)
    assert torch.equal(fe(x.reshape(1, 3, -1))[0], full)
    for C in (160, 1024):
        got, _ = StreamingMFCC(cfg, device=dev).process(x, C)
        for s in range(3):
            np.testing.assert_array_equal(got[s], full[s].cpu().numpy())


# K1's FPGA instantiation on this input, as the tree before Kaldi's
# recipe computed it (H100 80GB HBM3): the second instantiation leaves it
# bit for bit as it was.  The balanced mel schedule, which replaced the
# lane per filter in every kernel on the FP64 tail, was held to these
# digests on purpose: its split filters' sums move by FP64 ulp, and on this
# input no cepstrum's f32 rounding moves (max |d| against the lane per
# filter 0 at nfft 256, 512 and 1024, H100 80GB HBM3); a change that
# moves one re-pins them and says by how much.  The lane-per-filter loop,
# which a bank without a schedule takes, gives these digests too (reached
# here on the same bank by withholding its schedule).
K1_SHA1 = {256: "a03f48b6a61da20f0ab565e5834fc697cbe8a6b0",
           512: "0a41379e7cdbf6dbab4595ae4c5ff48c449beae6",
           1024: "bcfc49110605d8114c7c8e524807b916ae751594"}


@pytest.mark.cuda
@pytest.mark.parametrize("nfft,hop", [(256, 86), (512, 170), (1024, 340)])
def test_card_fpga_instantiation_unchanged(dev, nfft, hop, monkeypatch):
    x = torch.from_numpy(_speech_like(16, 16_000, seed=nfft)).to(dev)
    cfg = MFCCConfig(nfft=nfft, step=hop)
    before = fladder.MEL_SCHEDULE_LAUNCHES
    out = fladder.mfcc_float_ladder(x, cfg)
    assert fladder.MEL_SCHEDULE_LAUNCHES == before + 1
    digest = hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()
    assert digest == K1_SHA1[nfft]
    monkeypatch.setattr(fladder, "schedule_of", lambda mel: (None, 0))
    lanes = fladder.mfcc_float_ladder(x, cfg)
    assert fladder.MEL_SCHEDULE_LAUNCHES == before + 1
    assert hashlib.sha1(lanes.cpu().numpy().tobytes()).hexdigest() == \
        K1_SHA1[nfft]
