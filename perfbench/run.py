"""Run one cell of the benchmark on the card this process is started on:

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result (JSON); the last lines of
standard error are the numbers compared with their limits.  Without a CUDA
card, or with fewer cards than the cell asks for, it exits 2 and prints no
result.
"""

import time

T_START = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CACHE = Path(__file__).resolve().parent / "_cache"


def fixed_caches() -> None:
    """Every kernel cache at a fixed path inside the checkout (the port
    builds its libraries into ``mfcc_tpu_torch/_build/`` itself)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    fixed_caches()
    from perfbench import harness
    bench = harness.load_benchmark()
    cell, _ = harness.find_cell(bench, args.workload)
    import torch
    imported = time.perf_counter() - T_START
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"host has {torch.cuda.device_count()} (cuda available: "
              f"{torch.cuda.is_available()})", file=sys.stderr)
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START, marks={"torch imported": imported})
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
