"""The control of ``correct`` for the SeamlessM4T cell, and the readings
that place its limit: per seed, on the cell's own inputs and sizes and
judged by its comparison (``drivers/ragged_batch.py``), the reference in
float32 with every product's operands rounded to TF32 (the control, which
has to come out as not correct), wholly in float32 with TF32 off, and in
float32 with its spectrum by ``torch.fft.rfft`` (the program's algorithm
one precision down):

    python3 -m perfbench.seamless_control --seeds 1,2,3

Exits 0 when every seed's control came out not correct.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import harness
from .whisper_control import context


def readings(bench: dict, workload: str, seed: int, device,
             traffic_overrides: dict | None = None) -> dict:
    """{"control": checks, "float32": checks, "float32_fft": checks} of
    one seed."""
    ctx = context(bench, workload, seed, device, traffic_overrides)
    driver = harness.load_driver(ctx.traffic["driver"])
    return {"control": driver.control(ctx),
            "float32": driver.control(ctx, tf32=False),
            "float32_fft": driver.control(ctx, tf32=False, fft=True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="w2vbert.batch")
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    bench = harness.load_benchmark()
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        got = readings(bench, args.workload, seed, device)
        failed = not all(c.ok for c in got["control"])
        failed_all &= failed
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": not failed,
                          **{k: {c.name: c.value for c in v}
                             for k, v in got.items()}}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
