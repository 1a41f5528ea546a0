"""The benchmark's ``w2vbert.batch`` cell on the CPU at tiny sizes: its frozen
reference, its configuration and entries, its lengths and roofline counts,
a run of the cell through the harness, its per-layer readers, its control,
the faults its comparison has to catch (each planted in the recipe's plain
version, the CPU route), and a program without the recipe failing the cell
at once.  Nothing here imports JAX or ``mfcc_tpu``."""

import ast
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mfcc_tpu_torch import tables
from mfcc_tpu_torch.config import W2V_BERT_2_FBANK, SeamlessFbankConfig
from mfcc_tpu_torch.ops import framing, seamless
from mfcc_tpu_torch.ref import seamless_ref

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CELL = "w2vbert.batch"
TINY = {"utterances": 3, "samples": 16_000, "min_s": 0.2, "max_s": 1.0,
        "trace_seconds": 0.2}
NEW_FILES = ["perfbench/ref/seamless_ref.py",
             "mfcc_tpu_torch/ref/seamless_ref.py",
             "perfbench/drivers/ragged_batch.py",
             "perfbench/seamless_roofline.py",
             "perfbench/seamless_control.py",
             "perfbench/metrics/module.pad_frames_share.py",
             "perfbench/metrics/kernel.cmvn_roofline.py"]


@pytest.fixture(scope="module")
def bench():
    from perfbench import harness
    return harness.load_benchmark()


@pytest.fixture(autouse=True)
def _only_new_modules_forbidden(monkeypatch):
    """The harness refuses a run once JAX is loaded; other test files may
    have loaded it in this process before, so a run here is held to the
    modules that it loads itself."""
    from perfbench import harness
    before = {m.split(".")[0] for m in sys.modules}
    monkeypatch.setattr(harness, "forbidden_modules", lambda: sorted(
        ({m.split(".")[0] for m in sys.modules} - before)
        & set(harness.FORBIDDEN)))


def _run(bench, trace=False, seed=2**33 + 11):
    from perfbench import harness
    return harness.run_cell(bench, CELL, seed, 0.4, trace, CPU,
                            time.perf_counter(), TINY)


def _context(bench, seed, traffic=None):
    from perfbench import harness
    cell, conf = harness.find_cell(bench, CELL)
    t = harness.read_json(harness.traffic_path(cell["traffic"]))
    t.update(traffic or {})
    return harness.Context(CELL, harness.read_json(ROOT / conf["file"]), t,
                           seed, 1.0, False, CPU, 0.0)


def _limit(bench):
    return _context(bench, 0).config["limit"]


def test_frozen_reference_is_the_ports():
    assert (ROOT / "perfbench/ref/seamless_ref.py").read_bytes() == \
        (ROOT / "mfcc_tpu_torch/ref/seamless_ref.py").read_bytes()


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("rel", NEW_FILES)
def test_new_benchmark_files_import_no_jax(rel):
    names = _imports(ROOT / rel)
    assert not names & {"jax", "jaxlib", "mfcc_tpu"}
    if "ref/" in rel:
        assert names <= {"__future__", "math", "torch"}


def test_configuration_and_entries(bench):
    from perfbench import harness
    cell, conf = harness.find_cell(bench, CELL)
    config = harness.read_json(ROOT / conf["file"])
    assert conf["reduced"] == [] and config["reduced"] == []
    assert cell["chips"] == 1 and cell["traffic"] == "ragged_batch_20s"
    assert len(conf["source"]) <= 200 and len(cell["why"]) <= 200
    assert SeamlessFbankConfig(**config["mfcc"]) == W2V_BERT_2_FBANK
    assert seamless_ref.options(**config["seamless"]) == \
        seamless_ref.options()
    assert config["reference"] == "seamless_ref"
    assert 2.4e-7 < config["limit"] < 7e-6
    traffic = harness.read_json(harness.traffic_path(cell["traffic"]))
    assert (traffic["utterances"], traffic["samples"], traffic["inputs"],
            traffic["min_s"], traffic["max_s"]) == (384, 320_000, 2, 1, 20)
    e2e = {m["name"] for m in harness.cell_metrics(bench, CELL, False)}
    assert e2e == {"frames_per_s", "setup_s"}
    layer = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert layer == {"module.host_issue_us", "kernel.batch_roofline",
                     "device.idle.batch", "module.launches_per_call",
                     "module.pad_frames_share", "kernel.cmvn_roofline"}
    new = {m["name"]: m for m in bench["per_layer"][-2:]}
    assert new["module.pad_frames_share"] == {
        "name": "module.pad_frames_share", "unit": "%", "better": "lower",
        "source": "program_counter", "layer": "module",
        "moves": "frames_per_s", "workloads": [CELL]}
    assert new["kernel.cmvn_roofline"]["source"] == "device_trace"
    assert new["kernel.cmvn_roofline"]["workloads"] == [CELL]


def test_lengths_are_the_quantiles_in_a_seeded_order(bench):
    from perfbench.drivers import ragged_batch
    ctx = _context(bench, 2**40 + 3)
    n0, n1 = (ragged_batch.lengths(ctx, i) for i in range(2))
    assert n0.shape == (384,) and not (n0 == n1).all()
    assert np.array_equal(np.sort(n0), np.sort(n1))
    assert (ragged_batch.lengths(ctx, 0) == n0).all()
    assert n0.min() == 16_396 and n0.max() == 319_604
    counts = [seamless_ref.num_frames(int(n), seamless_ref.options())
              for n in n0]
    assert sum(counts) == 402_432 and max(counts) == 1_996
    padding = 1 - sum(counts) / (384 * 1_996)
    assert padding == pytest.approx(0.4749, abs=1e-4)


def test_roofline_count(bench):
    from perfbench import seamless_roofline
    from perfbench.drivers import ragged_batch
    opts = seamless_ref.options()
    n = seamless_roofline.ops_per_frame(opts)
    assert n == 5 * 400 + 1 + 4 * 64 * 40 + 19 * 256 + 2 * 501 + 8 * 80
    lens = ragged_batch.lengths(_context(bench, 5), 0).tolist()
    out = 384 * 1_996 * 80 * 4 + 384 * 998 * 4
    assert seamless_roofline.least_s(opts, lens) == pytest.approx(
        max((2 * sum(lens) + out) / 3.35e12, 402_432 * n / 67e12))
    assert seamless_roofline.cmvn_least_s(opts, lens) == pytest.approx(
        (402_432 * 80 * 8 + out) / 3.35e12)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_tiny(bench, trace):
    from perfbench import harness
    res = _run(bench, trace)
    assert res["correct"], res["checks"]
    assert res["checks"]["max_abs_err"]["value"] <= 5e-7
    for name in ("mask_off", "padding_off", "nonfinite_off",
                 "output_shape_off"):
        assert res["checks"][name]["value"] == 0
    wanted = {m["name"] for m in harness.cell_metrics(bench, CELL, trace)}
    if trace:                  # the plain version: no launch, no kernel
        assert set(res["metrics"]) <= wanted
        assert res["metrics"]["module.launches_per_call"]["value"] == 0
        assert "module.pad_frames_share" not in res["metrics"]
        assert "kernel.cmvn_roofline" not in res["metrics"]
    else:
        assert set(res["metrics"]) == wanted


def test_readers_read_their_records():
    from perfbench import harness
    pad = harness.load_reader("module.pad_frames_share")
    assert pad({"frames": {"computed": 402_432, "own": 402_432}}) == 0.0
    assert pad({"frames": {"computed": 766_464, "own": 402_432}}) == \
        pytest.approx(47.495, abs=1e-3)
    assert pad({"frames": None}) is None and pad({}) is None
    cmvn = harness.load_reader("kernel.cmvn_roofline")
    prof = {"busy_s": 2.0, "window_s": 2.01, "device_ops": [
        ["void (anonymous namespace)::fbank_walk<short>(...)", 1.7],
        ["(anonymous namespace)::fbank_cmvn(double const*, ...)", 0.3]]}
    layer = {"profile": prof, "profiled_calls": 1000,
             "cmvn_least_s": 1.5e-4}
    assert cmvn(layer) == pytest.approx(50.0)
    prof["device_ops"] = prof["device_ops"][:1]
    assert cmvn(layer) is None and cmvn({}) is None


def _faulty(over_padding=False, ddof0=False, odd_pairs=False,
            hamming=False):
    """The recipe's plain version with one step changed."""
    def fbank_plain(audio, lengths, cfg, operators=None):
        x = audio if audio.dim() == 2 else audio[None]
        B, T = x.shape
        counts = seamless.frame_counts(lengths, B, T, cfg)
        Fp, nf = seamless.padded_frames(counts, cfg), cfg.nfilters
        Fmax = int(counts.max())
        frames = x.to(torch.float64).unfold(-1, 400, 160)[:, :Fmax]
        y = framing.kaldi_preemphasis(frames, 0.97)
        win = torch.as_tensor(tables.povey_window(400))
        if hamming:
            win = torch.hamming_window(400, periodic=False,
                                       dtype=torch.float64)
        y = torch.nn.functional.pad(y * win, (0, 112))
        spec = torch.fft.rfft(y, dim=-1)[..., :256]
        mel = torch.as_tensor(tables.seamless_mel_matrix(16000, 512, nf))
        L = torch.log(torch.clamp_min((spec.abs() ** 2) @ mel,
                                      tables.FLT_EPSILON))
        F = torch.as_tensor(counts)[:, None, None]
        own = torch.arange(Fmax)[None, :, None] < F
        if over_padding:                  # every frame up to F_pad
            own = torch.ones_like(own)
            F = torch.full_like(F, Fmax)
        mean = torch.where(own, L, 0.0).sum(1, keepdim=True) / F
        d = torch.where(own, L - mean, 0.0)
        var = (d * d).sum(1, keepdim=True) / (F if ddof0 else F - 1)
        out = torch.zeros((B, Fp + 1, nf), dtype=torch.float32)
        real = torch.arange(Fmax)[None, :, None] < torch.as_tensor(
            counts)[:, None, None]
        out[:, :Fmax] = torch.where(real, d / torch.sqrt(var + 1e-7),
                                    0.0).float()
        out = out[:, 1:] if odd_pairs else out[:, :Fp]
        mask = (torch.arange(1, Fp, 2)[None, :]
                < torch.as_tensor(counts)[:, None]).int()
        return out.reshape(B, Fp // 2, 2 * nf), mask
    return fbank_plain


@pytest.mark.parametrize("fault", [{"over_padding": True}, {"ddof0": True},
                                   {"odd_pairs": True}, {"hamming": True}])
def test_the_cells_comparison_catches_planted_faults(bench, monkeypatch,
                                                     fault):
    monkeypatch.setattr(seamless, "fbank_plain", _faulty(**fault))
    res = _run(bench, seed=2**35 + 1)
    assert not res["correct"]
    assert res["checks"]["max_abs_err"]["value"] > 10 * _limit(bench)


def test_the_faultless_stand_in_is_correct(bench, monkeypatch):
    """The faults' stand-in with no fault planted passes: each fault's
    reading is its fault's."""
    monkeypatch.setattr(seamless, "fbank_plain", _faulty())
    res = _run(bench, seed=2**35 + 1)
    assert res["correct"], res["checks"]


def test_the_control_is_not_correct(bench):
    from perfbench import seamless_control
    got = seamless_control.readings(bench, CELL, 2**32 + 9, CPU, TINY)
    control = {c.name: c.value for c in got["control"]}
    assert not all(c.ok for c in got["control"])
    assert control["max_abs_err"] > 10 * _limit(bench)
    # the reference wholly in float32, TF32 off, fails too: a float32
    # interior does not pass the limit
    f32 = {c.name: c.value for c in got["float32"]}
    assert 3 * _limit(bench) < f32["max_abs_err"] < control["max_abs_err"]
    # and so does the program's own algorithm one precision down: the
    # spectrum by torch.fft.rfft in complex64
    fft = {c.name: c.value for c in got["float32_fft"]}
    assert 3 * _limit(bench) < fft["max_abs_err"]
    for name in ("nonfinite_off", "mask_off", "padding_off"):
        assert control[name] == 0 and f32[name] == 0 and fft[name] == 0


def test_the_references_fft_is_its_dft():
    """``fft=True`` changes how the spectrum is computed, not what: in
    float64 it gives the tables' product to rounding."""
    opts = seamless_ref.options()
    x = torch.from_numpy(np.random.default_rng(3).integers(
        -20000, 20000, (2, 4000)).astype(np.float64))
    n = torch.tensor([4000, 2321])
    dft, dmask = seamless_ref.features(x, n, opts)
    fft, fmask = seamless_ref.features(x, n, opts, fft=True)
    assert torch.equal(dmask, fmask)
    assert float((dft - fft).abs().max()) < 1e-9


def test_the_parent_program_refuses_the_recipe_at_once(bench, monkeypatch):
    """A program without ``SeamlessFbankConfig`` fails the cell before any
    timing (an ImportError in ``drivers/ragged_batch.py``), not with a
    wrong answer."""
    import mfcc_tpu_torch.config as config
    monkeypatch.delattr(config, "SeamlessFbankConfig")
    with pytest.raises(ImportError):
        _run(bench)
