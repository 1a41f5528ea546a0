"""The general harness: it reads ``BENCHMARK.json``, finds a cell's
configuration, traffic mix, driver and per-layer readers by name, runs the
driver and assembles the result line.  Everything that belongs to one
configuration, mix or metric is a file of its own:

* ``configs/<config>.json``: the deployment (``mfcc``: the configuration's
  fields, ``path``: "float" or "int", ``precision``, ``limit``: the
  contract's limit, ``source``, ``assumed``, ``reduced``);
* ``traffic/<mix>.json``: the mix's parameters and the ``driver`` that
  runs it (``drivers/<driver>.py``);
* ``metrics/<metric>.py``: ``read(layer) -> float | None`` over what the
  driver recorded.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mfcc_tpu")


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def traffic_path(mix: str) -> Path:
    return HERE / "traffic" / f"{mix}.json"


def metric_path(metric: str) -> Path:
    return HERE / "metrics" / f"{metric}.py"


def find_cell(bench: dict, workload: str) -> tuple[dict, dict]:
    """(the cell, its configuration's entry)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, conf


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics, or with ``trace`` its per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def load_driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def load_reader(metric: str) -> Callable:
    """``read`` of ``metrics/<metric>.py`` (names hold dots, so the file is
    loaded by its path)."""
    path = metric_path(metric)
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that a run may not hold, compared
    whole (``mfcc_tpu_torch`` is not ``mfcc_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Check:
    """One number compared with its limit: it holds when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Context:
    """What a driver is given."""
    workload: str
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<mix>.json
    seed: int
    seconds: float
    trace: bool
    device: object        # torch.device
    t_start: float        # perf_counter() at process start
    marks: dict = dataclasses.field(default_factory=dict)

    def mark(self, what: str) -> None:
        """Note how far set-up has come: seconds since process start."""
        self.marks[what] = time.perf_counter() - self.t_start

    def program_config(self):
        from mfcc_tpu_torch.config import MFCCConfig
        return MFCCConfig(**self.config["mfcc"])

    def ref_config(self):
        from .ref.config import MFCCConfig
        return MFCCConfig(**self.config["mfcc"])


@dataclasses.dataclass
class Outcome:
    """What a driver returns once its window has closed."""
    e2e: dict                       # end-to-end metric name -> value
    layer: dict                     # what the per-layer readers read
    attempted: int
    failed: int
    memory_peak_bytes: int
    check: Callable[[], list]       # runs the reference: [Check, ...]
    profile: dict | None = None     # trace.summarize's, --trace 1 only
    extra: dict = dataclasses.field(default_factory=dict)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             traffic_overrides: dict | None = None,
             marks: dict | None = None) -> dict:
    """Run one cell and return its result line as a dict (``checks``
    last).  Raises if a forbidden module is loaded once the window has
    closed.  ``marks``: set-up already done (seconds since process
    start)."""
    cell, conf = find_cell(bench, workload)
    config = read_json(ROOT / conf["file"])
    traffic = read_json(traffic_path(cell["traffic"]))
    traffic.update(traffic_overrides or {})
    ctx = Context(workload, config, traffic, seed, seconds, trace, device,
                  t_start, dict(marks or {}))
    ctx.mark("harness")
    out = load_driver(traffic["driver"]).run(ctx)
    found = forbidden_modules()
    if found:
        raise RuntimeError("the run loaded " + ", ".join(found))
    checks = out.check()
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = (load_reader(m["name"])(out.layer) if trace
                 else out.e2e[m["name"]])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_name(device), "count": cell["chips"],
           "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": all(c.ok for c in checks),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace and out.profile is not None:
        dev["busy_s"] = out.profile["busy_s"]
        dev["window_s"] = out.profile["window_s"]
        result["breakdown"] = {k: out.profile[k]
                               for k in ("device_ops", "idle_gaps")}
    result["setup_marks_s"] = ctx.marks
    result.update(out.extra)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result


def _device_name(device) -> str:
    if device.type == "cuda":
        import torch
        return torch.cuda.get_device_name(device)
    return device.type
