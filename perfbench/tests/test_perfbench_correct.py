"""``correct`` and its control on the CPU at tiny sizes: the harness's look
for a card skipped, the rest of a run driven with the timed path broken
underneath, and ``correct`` seen to come out false once for each fault a
cell can have; and each cell's control (the reference one precision below
the configuration's) seen to fail the cell's comparison."""

import time

import pytest
import torch

from perfbench import control, harness
from perfbench.tests.test_perfbench_harness import CPU, TINY


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def run(bench, workload, seed=2**33 + 5):
    return harness.run_cell(bench, workload, seed, 0.4, False, CPU,
                            time.perf_counter(), TINY[workload])


def test_batch_with_half_the_streams_left_out(bench, monkeypatch):
    from mfcc_tpu_torch import MFCC
    forward = MFCC.forward

    def half(self, audio):
        out = forward(self, audio[: audio.shape[0] // 2])
        fill = out.mean(dim=0, keepdim=True).expand(
            audio.shape[0] - out.shape[0], *out.shape[1:])
        return torch.cat([out, fill])
    monkeypatch.setattr(MFCC, "forward", half)
    res = run(bench, "float.batch")
    assert not res["correct"] and res["checks"]["max_abs_err"]["value"] > 1


@pytest.mark.parametrize("workload", ["float.batch", "int.batch"])
def test_batch_with_one_answer_altered(bench, monkeypatch, workload):
    from mfcc_tpu_torch import MFCC
    name = "int" if workload == "int.batch" else "forward"
    entry = getattr(MFCC, name)

    def altered(self, audio):
        out = entry(self, audio).clone()
        out[-1, -1, -1] += 1
        return out
    monkeypatch.setattr(MFCC, name, altered)
    assert not run(bench, workload)["correct"]


def test_stream_step_that_returns_its_state_unchanged(bench, monkeypatch):
    from mfcc_tpu_torch import StreamingMFCC
    step = StreamingMFCC.step

    def stale(self, chunks, state, *a, **k):
        feats, mask, _ = step(self, chunks, state, *a, **k)
        return feats, mask, state
    monkeypatch.setattr(StreamingMFCC, "step", stale)
    res = run(bench, "float.stream")
    assert not res["correct"] and res["checks"]["max_abs_err"]["value"] > 1


def test_stream_with_one_answer_altered(bench, monkeypatch):
    from mfcc_tpu_torch import StreamingMFCC
    step = StreamingMFCC.step

    def altered(self, chunks, state, *a, **k):
        feats, mask, new = step(self, chunks, state, *a, **k)
        feats = feats.clone()
        feats[-1, 0, 3] += 1e-3
        return feats, mask, new
    monkeypatch.setattr(StreamingMFCC, "step", altered)
    assert not run(bench, "float.stream")["correct"]


def test_serve_with_one_answer_altered(bench, monkeypatch):
    from mfcc_tpu_torch import StreamingMFCC
    step = StreamingMFCC.step

    def altered(self, chunks, state, *a, **k):
        feats, mask, new = step(self, chunks, state, *a, **k)
        feats = feats.clone()
        feats[:, 0, 5] += 1
        return feats, mask, new
    monkeypatch.setattr(StreamingMFCC, "step", altered)
    res = run(bench, "int.serve")
    assert not res["correct"] and res["checks"]["elements_off"]["value"] > 0


def test_serve_that_answers_no_one(bench, monkeypatch):
    from mfcc_tpu_torch import FeatureServer
    monkeypatch.setattr(FeatureServer, "_deliver",
                        lambda self, wire, mask, active, event:
                        self._clear_busy(active))
    res = run(bench, "int.serve")
    assert not res["correct"] and res["failed"] > 0


@pytest.mark.parametrize("workload", sorted(TINY))
def test_the_control_is_not_correct(bench, workload):
    checks = control.readings(bench, workload, 2**32 + 3, 1.0, 50, CPU,
                              TINY[workload])
    assert not all(c.ok for c in checks)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(TINY))
def test_the_control_is_not_correct_on_the_card(bench, card, workload):
    checks = control.readings(bench, workload, 2**32 + 4, 1.0, 50, card,
                              TINY[workload])
    assert not all(c.ok for c in checks)
