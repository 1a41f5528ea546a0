"""Run cells several times, one process a run, and print each run's
result beside the spread of every metric: the distance between the first
and third quartiles (``statistics.quantiles(values, n=4)``) as a share of
the median.  The way the bounds in ``BENCHMARK.json`` were set:

    python3 -m perfbench.sets --workload float.batch --seeds 11,12,13 \
        --seconds 20 --trace 0 [--out sets.jsonl]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], capture_output=True, text=True)
    wall = time.perf_counter() - t
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "seconds": seconds,
            "trace": trace, "rc": proc.returncode, "wall_s": wall,
            "result": result, "stderr_tail": proc.stderr[-3000:]}


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True,
                    help="a cell, or several joined by commas")
    ap.add_argument("--seeds", required=True,
                    help="seeds joined by commas, one run each")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", help="append every run's record to this file")
    args = ap.parse_args(argv)
    print(f"card: {card()}", flush=True)
    bad = 0
    for workload in args.workload.split(","):
        runs = []
        for seed in (int(s) for s in args.seeds.split(",")):
            run = one(workload, seed, args.seconds, args.trace)
            runs.append(run)
            if args.out:
                with Path(args.out).open("a") as f:
                    f.write(json.dumps(run) + "\n")
            res = run["result"]
            bad += run["rc"] != 0 or not res or not res.get("correct")
            print(json.dumps({"workload": workload, "seed": seed,
                              "rc": run["rc"],
                              "wall_s": round(run["wall_s"], 1),
                              "result": res}), flush=True)
            if run["rc"] != 0 or not res:
                print(run["stderr_tail"], flush=True)
        values = {}
        for run in runs:
            for name, m in ((run["result"] or {}).get("metrics") or {}
                            ).items():
                values.setdefault(name, []).append(m["value"])
        for name, vs in values.items():
            print(f"{workload} {name}: median {statistics.median(vs)!r} "
                  f"spread {spread(vs)!r} over {len(vs)} runs: {vs}",
                  flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
