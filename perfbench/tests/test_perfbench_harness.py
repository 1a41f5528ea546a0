"""The harness on the CPU: the files found by name, new ones picked up with
no edit, the open-loop latency arithmetic, the roofline counts, the result
line's keys, the refusal to measure without a card, and ``correct`` coming
out false under each fault a cell can have."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, roofline
from perfbench.drivers import clients
from perfbench.ref.config import MFCCConfig

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}
TINY = {"float.batch": {"streams": 3, "samples": 2000, "trace_seconds": 0.2},
        "int.batch": {"streams": 2, "samples": 1200, "trace_seconds": 0.2},
        "float.stream": {"streams": 4, "ring_chunks": 6, "keep": 2,
                         "trace_seconds": 0.2},
        "int.serve": {"clients": 3, "sample_clients": 2, "grace_s": 10.0,
                      "trace_seconds": 0.3}}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def run(bench, workload, trace=False, seconds=0.5, seed=2**31 + 11):
    return harness.run_cell(bench, workload, seed, seconds, trace, CPU,
                            time.perf_counter(), TINY[workload])


def test_every_cell_finds_its_files(bench):
    for cell in bench["workloads"]:
        _, conf = harness.find_cell(bench, cell["name"])
        config = harness.read_json(ROOT / conf["file"])
        assert config["name"] == conf["name"]
        traffic = harness.read_json(harness.traffic_path(cell["traffic"]))
        assert harness.load_driver(traffic["driver"]).run
        for trace in (False, True):
            for m in harness.cell_metrics(bench, cell["name"], trace):
                if trace:
                    assert harness.load_reader(m["name"])({}) is None
    assert {c["name"] for c in bench["configs"]} == {
        w["config"] for w in bench["workloads"]}


def test_files_dropped_in_are_found_by_name(bench, tmp_path, monkeypatch):
    here = tmp_path / "perfbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(harness.HERE / sub, here / sub)
    config = json.loads((here / "configs" / "fpga_int.json").read_text())
    config.update(name="fpga_int_narrow", mfcc={**config["mfcc"],
                                                "nceptrums": 16})
    (here / "configs" / "fpga_int_narrow.json").write_text(json.dumps(config))
    traffic = json.loads((here / "traffic" / "batch_4s.json").read_text())
    traffic.update(streams=2, samples=1000)
    (here / "traffic" / "batch_tiny.json").write_text(json.dumps(traffic))
    (here / "metrics" / "module.calls_seen.py").write_text(
        "def read(layer):\n    return float(len(layer['call_host_us']))\n")
    monkeypatch.setattr(harness, "HERE", here)
    bench = json.loads(json.dumps(bench))
    bench["configs"].append({"name": "fpga_int_narrow", "source": "x",
                             "file": str(here / "configs"
                                         / "fpga_int_narrow.json"),
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "int.tiny", "config":
                               "fpga_int_narrow", "traffic": "batch_tiny",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "module.calls_seen", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "module", "moves": "frames_per_s",
                               "workloads": ["int.tiny"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "int.batch" in m["workloads"]:
            m["workloads"].append("int.tiny")
    bench["per_layer"] = [m for m in bench["per_layer"]
                          if "int.tiny" in m.get("workloads", ["int.tiny"])]
    res = harness.run_cell(bench, "int.tiny", 5, 0.4, True, CPU,
                           time.perf_counter(), {"trace_seconds": 0.1})
    assert res["correct"]
    assert res["metrics"]["module.calls_seen"]["value"] > 0
    res = harness.run_cell(bench, "int.tiny", 5, 0.3, False, CPU,
                           time.perf_counter())
    assert res["correct"] and res["metrics"]["frames_per_s"]["value"] > 0


def test_open_loop_latency_runs_from_the_due_time():
    p = {"clients": 1, "chunk": 1024, "ring_chunks": 2, "samplerate": 16000,
         "seconds": 1.0, "warm_s": 0.0, "seed": 3, "sample": [], "ncep": 32,
         "windowlen": 512, "hop": 170}
    load = clients.Load(p)
    load.phase[:] = 0.0
    load.t_load = load.t0 = 100.0
    load.t1 = 101.0
    frame = b"\0" * load.fsize
    period = load.period
    # chunks 0..3 answered 5 ms after their due times, then a 200 ms stall
    # that holds chunks 4..6, then all answered at once
    for k in range(4):
        got = int(load.need[k]) - load.rx[0] // load.fsize
        load.on_bytes(0, frame * got, 100.0 + k * period + 0.005)
    stall_end = 100.0 + 4 * period + 0.2
    load.on_bytes(0, frame * (load.need[6] - load.need[3]), stall_end)
    lat = load.lat[0]
    np.testing.assert_allclose(lat[:4], 0.005)
    np.testing.assert_allclose(lat[4:7], stall_end - (
        100.0 + np.arange(4, 7) * period))
    assert np.isnan(lat[7:]).all()
    # the stall raises the tail: every delayed chunk counts from its due
    # time, not from a send that the stall itself put off
    assert np.percentile(lat[:7], 95) > 0.1
    assert chunks_completed(7) == load.need[6]


def chunks_completed(k):
    return int(clients.chunk_frames(k - 1, 1024, 512, 170))


def test_roofline_reproduces_the_counts():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from mfcc_tpu_torch.config import MFCCConfig as PortConfig
    from mfcc_tpu_torch.ops import fladder, int_fused
    cfg, port = MFCCConfig(), PortConfig()
    assert roofline.int_ops_per_frame(cfg, roofline.int_bands(cfg)) == \
        55_030 == chip_smoke.int_ops_per_frame(
            port, int_fused.int_operators(port, CPU).band)
    assert roofline.k1_flops_per_frame(cfg, roofline.float_bands(cfg)) == \
        chip_smoke.k1_flops_per_frame(
            port, fladder.default_operators(port, CPU).band)
    t, kind = roofline.batch_call(cfg, "float", 1024, 63_922)
    assert kind == "operations" and abs(t - 1.1187e-4) < 1e-8
    t, kind = roofline.batch_call(cfg, "int", 1024, 63_922)
    assert kind == "operations" and abs(t - 6.378e-4) < 1e-7


@pytest.mark.parametrize("workload", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_gives_the_result_line(bench, workload, trace):
    res = run(bench, workload, trace)
    assert REQUIRED <= set(res) and list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "cpu"
    wanted = {m["name"] for m in harness.cell_metrics(bench, workload,
                                                      trace)}
    if not trace:
        assert set(res["metrics"]) == wanted
    else:
        # on the CPU nothing reads the device: its metrics are left out
        assert set(res["metrics"]) <= wanted
        assert not any(k.startswith(("device.", "kernel."))
                       for k in res["metrics"])


def test_without_a_card_the_command_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", "int.batch",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                             "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert "CUDA" in proc.stderr


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mfcc_tpu_torchx", sys)
    assert "mfcc_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
