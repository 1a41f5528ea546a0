"""The benchmark's ``whisper.batch`` cell on the CPU at tiny sizes: its
frozen reference, its configuration and entries, its roofline count, a run
of the cell through the harness, its control, the faults its comparison
has to catch (each planted in the recipe's plain version, the CPU route),
and a program without the recipe failing the cell at once.  Nothing here
imports JAX or ``mfcc_tpu``."""

import ast
import sys
import time
from pathlib import Path

import pytest
import torch

from mfcc_tpu_torch.config import WHISPER_V3_LOG_MEL, WhisperConfig
from mfcc_tpu_torch.ops import whisper
from mfcc_tpu_torch.ref import whisper_ref

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CELL = "whisper.batch"
TINY = {"windows": 3, "samples": 16_000, "speech_min_s": 0.2,
        "speech_max_s": 1.0, "trace_seconds": 0.2}
NEW_FILES = ["perfbench/ref/whisper_ref.py", "mfcc_tpu_torch/ref/whisper_ref.py",
             "perfbench/drivers/window_batch.py",
             "perfbench/whisper_roofline.py", "perfbench/whisper_control.py",
             "perfbench/metrics/kernel.norm_share.py"]


@pytest.fixture(scope="module")
def bench():
    from perfbench import harness
    return harness.load_benchmark()


@pytest.fixture(autouse=True)
def _only_new_modules_forbidden(monkeypatch):
    """The harness refuses a run once JAX is loaded; other test files may
    have loaded it in this process before, so a run here is held to the
    modules that it loads itself (the new files' imports are checked
    apart, below)."""
    from perfbench import harness
    before = {m.split(".")[0] for m in sys.modules}
    monkeypatch.setattr(harness, "forbidden_modules", lambda: sorted(
        ({m.split(".")[0] for m in sys.modules} - before)
        & set(harness.FORBIDDEN)))


def _run(bench, trace=False, seed=2**33 + 11):
    from perfbench import harness
    return harness.run_cell(bench, CELL, seed, 0.4, trace, CPU,
                            time.perf_counter(), TINY)


def _limit(bench):
    from perfbench import harness
    _, conf = harness.find_cell(bench, CELL)
    return harness.read_json(ROOT / conf["file"])["limit"]


def test_frozen_reference_is_the_ports():
    assert (ROOT / "perfbench/ref/whisper_ref.py").read_bytes() == \
        (ROOT / "mfcc_tpu_torch/ref/whisper_ref.py").read_bytes()


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
    assert conf["reduced"] == [] and cell["chips"] == 1
    assert cell["traffic"] == "window_batch_30s"
    assert len(conf["source"]) <= 200 and len(cell["why"]) <= 200
    assert WhisperConfig(**config["mfcc"]) == WHISPER_V3_LOG_MEL
    assert whisper_ref.options(**config["whisper"]) == whisper_ref.options()
    assert config["reference"] == "whisper_ref" and config["reduced"] == []
    traffic = harness.read_json(harness.traffic_path(cell["traffic"]))
    assert (traffic["windows"], traffic["samples"], traffic["inputs"]) == (
        128, 480_000, 2)
    assert (traffic["speech_min_s"], traffic["speech_max_s"]) == (1, 30)
    e2e = {m["name"] for m in harness.cell_metrics(bench, CELL, False)}
    assert e2e == {"frames_per_s", "setup_s"}
    layer = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert layer == {"module.host_issue_us", "kernel.batch_roofline",
                     "device.idle.batch", "module.launches_per_call",
                     "kernel.norm_share"}
    norm = [m for m in bench["per_layer"] if m["name"] == "kernel.norm_share"]
    assert norm == [{"name": "kernel.norm_share", "unit": "%",
                     "better": "lower", "source": "device_trace",
                     "layer": "kernel", "moves": "frames_per_s",
                     "workloads": [CELL]}]


def test_roofline_count():
    from perfbench import whisper_roofline
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    opts = whisper_ref.options()
    n = whisper_roofline.ops_per_frame(opts)
    assert n == 400 + 25 * 56 + 80 * 72 + 19 * 200 + 2 * 394 + 6 * 128
    mel = whisper.default_operators(WHISPER_V3_LOG_MEL, CPU).mel
    assert chip_smoke.whisper_ops_per_frame(WHISPER_V3_LOG_MEL, mel) == n
    # bytes bound: 122.88 MB of int16 in, 196.608 MB of f32 out
    assert whisper_roofline.least_s(opts, 128, 480_000) == pytest.approx(
        319_488_000 / 3.35e12)
    assert 384_000 * n / 67e12 < 319_488_000 / 3.35e12


def test_speech_lengths_are_seeded(bench):
    from perfbench import harness
    from perfbench.drivers import window_batch
    cell, conf = harness.find_cell(bench, CELL)
    traffic = harness.read_json(harness.traffic_path(cell["traffic"]))
    ctx = harness.Context(CELL, harness.read_json(ROOT / conf["file"]),
                          traffic, 2**40 + 3, 1.0, False, CPU, 0.0)
    n0, n1 = (window_batch.speech_lengths(ctx, i) for i in range(2))
    assert n0.shape == (128,) and not (n0 == n1).all()
    assert n0.min() >= 16_000 and n0.max() <= 480_000
    assert (window_batch.speech_lengths(ctx, 0) == n0).all()


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_tiny(bench, trace):
    from perfbench import harness
    res = _run(bench, trace)
    assert res["correct"], res["checks"]
    assert res["checks"]["max_abs_err"]["value"] <= 3e-7
    wanted = {m["name"] for m in harness.cell_metrics(bench, CELL, trace)}
    if trace:                  # the plain version: no launch, no kernel
        assert set(res["metrics"]) <= wanted
        assert res["metrics"]["module.launches_per_call"]["value"] == 0
        assert "kernel.norm_share" not in res["metrics"]
    else:
        assert set(res["metrics"]) == wanted


def test_norm_share_reads_the_trace():
    from perfbench import harness
    read = harness.load_reader("kernel.norm_share")
    prof = {"busy_s": 2.0, "window_s": 2.01, "device_ops": [
        ["void (anonymous namespace)::whisper_logmel_kernel<short>(...)",
         1.8],
        ["(anonymous namespace)::whisper_norm_kernel(float*, ...)", 0.12]]}
    assert read({"profile": prof}) == pytest.approx(6.0)
    prof["device_ops"] = prof["device_ops"][:1]
    assert read({"profile": prof}) is None
    assert read({}) is None


def _faulty(pad="reflect", symmetric=False, keep_last=False,
            batch_max=False):
    """The recipe's plain version with one step changed."""
    def log_mel_plain(audio, cfg, operators=None):
        ops = operators or whisper.default_operators(cfg, audio.device)
        T, h = audio.shape[-1], cfg.nfft // 2
        x = audio.reshape(-1, T).to(torch.float64)
        xp = torch.nn.functional.pad(x[:, None], (h, h), mode=pad)[:, 0]
        frames = xp.unfold(-1, cfg.nfft, cfg.hop)
        if not keep_last:
            frames = frames[:, :-1]
        win = ops.window
        if symmetric:
            win = torch.hann_window(cfg.nfft, periodic=False,
                                    dtype=torch.float64) / 32768.0
        spec = torch.fft.rfft(frames * win, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        L = torch.log10(torch.clamp_min(power @ ops.mel, 1e-10))
        L = L.to(torch.float32).transpose(-1, -2)
        dims = (0, 1, 2) if batch_max else (1, 2)
        top = L.amax(dim=dims, keepdim=True)
        return (torch.maximum(L, top - 8.0) + 4.0) * 0.25
    return log_mel_plain


@pytest.mark.parametrize("fault,check", [
    ({"pad": "constant"}, "max_abs_err"),
    ({"symmetric": True}, "max_abs_err"),
    ({"keep_last": True}, "output_shape_off"),
    ({"batch_max": True}, "max_abs_err")])
def test_the_cells_comparison_catches_planted_faults(bench, monkeypatch,
                                                     fault, check):
    monkeypatch.setattr(whisper, "log_mel_plain", _faulty(**fault))
    res = _run(bench, seed=2**35 + 1)
    assert not res["correct"]
    assert res["checks"][check]["value"] > (
        10 * _limit(bench) if check == "max_abs_err" else 0)


def test_the_faultless_stand_in_is_correct(bench, monkeypatch):
    """The faults' stand-in with no fault planted passes: each fault's
    reading is its fault's."""
    monkeypatch.setattr(whisper, "log_mel_plain", _faulty())
    res = _run(bench, seed=2**35 + 1)
    assert res["correct"], res["checks"]


def test_the_control_is_not_correct(bench):
    from perfbench import whisper_control
    got = whisper_control.readings(bench, CELL, 2**32 + 9, CPU, TINY)
    control = {c.name: c.value for c in got["control"]}
    assert not all(c.ok for c in got["control"])
    assert control["max_abs_err"] > 3 * _limit(bench)
    assert control["nonfinite_off"] == 0
    # Whisper's own precision, float32 with TF32 off, reads between the
    # program and the control
    f32 = {c.name: c.value for c in got["float32"]}
    assert 3e-7 < f32["max_abs_err"] < control["max_abs_err"]


def test_the_parent_program_refuses_the_recipe_at_once(bench, monkeypatch):
    """A program without ``WhisperConfig`` fails the cell before any timing
    (an ImportError in ``drivers/window_batch.py``), not with a wrong
    answer."""
    import mfcc_tpu_torch.config as config
    monkeypatch.delattr(config, "WhisperConfig")
    with pytest.raises(ImportError):
        _run(bench)
