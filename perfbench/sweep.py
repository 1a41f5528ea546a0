"""The knee of a serving cell: its run at each of several client counts, one
process a count, with the served share of the offered load and the median
latency of the chunks due in each quarter of the window.  The knee is the
highest count, in rising order, before the first at which the backlog
grows over the window: where the served share falls 2% below the offered,
or the last quarter's median rises above 1.5 times the second's, plus 5 ms.
The cell runs at 4/5 of it:

    python3 -m perfbench.sweep --workload int.serve \
        --clients 64,128,192,256 --seconds 20 --seed 7
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def grows(load: dict, served: float) -> bool:
    q = load["p50_ms_by_quarter"]
    return served < 0.98 * load["clients"] or q[3] > 1.5 * q[1] + 5.0


def one(args) -> int:
    import torch
    from perfbench import harness
    result = harness.run_cell(
        harness.load_benchmark(), args.workload, args.seed, args.seconds,
        False, torch.device("cuda", 0), time.perf_counter(),
        {"clients": args.one})
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="int.serve")
    ap.add_argument("--clients", default="64,128,192,256")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--repeat", type=int, default=1,
                    help="runs a count, each with its own seed; the backlog "
                         "grows at a count where it grows in any of them")
    ap.add_argument("--one", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        return one(args)
    knee, stop = None, False
    for n in (int(c) for c in args.clients.split(",")):
        for r in range(args.repeat):
            proc = subprocess.run(
                [sys.executable, "-m", "perfbench.sweep", "--workload",
                 args.workload, "--seconds", str(args.seconds), "--seed",
                 str(args.seed + r), "--one", str(n)], capture_output=True,
                text=True)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode or not lines:
                print(f"clients {n}: rc {proc.returncode}\n"
                      f"{proc.stderr[-3000:]}")
                stop = True
                continue
            res = json.loads(lines[-1])
            m, load = res["metrics"], res["load"]
            served = m["served_streams"]["value"]
            grew = grows(load, served)
            stop = stop or grew
            print(json.dumps({
                "clients": n, "seed": args.seed + r,
                "served_streams": served, "served_share": served / n,
                "reply_p95_ms": load["reply_p95_ms"],
                "p50_ms_by_quarter": load["p50_ms_by_quarter"],
                "sender_late_p99_ms": load["sender_late_p99_ms"],
                "failed": res["failed"], "correct": res["correct"],
                "backlog_grows": grew}), flush=True)
        if not stop:
            knee = n
    print(f"knee: {knee} clients; 4/5 of it: "
          f"{None if knee is None else int(knee * 4 / 5)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
