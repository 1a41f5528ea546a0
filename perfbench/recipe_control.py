"""The control of ``correct`` for a cell whose driver brings its own
(``drivers/<driver>.py`` ``control(ctx)``, such as ``recipe_batch``): the
plain reference one precision below the configuration's, in the program's
place, on the cell's own inputs and sizes, judged by the cell's own
comparison.  It has to come out as not correct:

    python3 -m perfbench.recipe_control --workload kaldi.batch --seeds 1,2,3

The arguments are ``perfbench.control``'s; ``--steps`` is taken and unused.
Exits 0 when every seed's control came out not correct.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import harness


def readings(bench: dict, workload: str, seed: int, seconds: float, device,
             traffic_overrides: dict | None = None) -> list:
    cell, conf = harness.find_cell(bench, workload)
    traffic = harness.read_json(harness.traffic_path(cell["traffic"]))
    traffic.update(traffic_overrides or {})
    ctx = harness.Context(workload, harness.read_json(harness.ROOT
                                                      / conf["file"]),
                          traffic, seed, seconds, False, device, 0.0)
    return harness.load_driver(traffic["driver"]).control(ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--steps", type=int, default=100_000)
    args = ap.parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    bench = harness.load_benchmark()
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        checks = readings(bench, args.workload, seed, args.seconds, device)
        failed = not all(c.ok for c in checks)
        failed_all &= failed
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": not failed,
                          "checks": {c.name: c.value for c in checks}}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
