"""Count each kernel's SASS instructions by opcode, from a ``cuobjdump``
listing of one of the built libraries.

    cuobjdump -sass mfcc_tpu_torch/_build/libint_mfcc-<hash>.so > int.sass
    python3 mfcc_tpu_torch/tools/sass_mix.py int.sass [SUBSTRING ...]

Prints one JSON line per kernel of the listing (each ``Function :``
section whose mangled name contains every SUBSTRING given): the name, the
kernel's static instruction count, the count of each opcode (the
mnemonic before its first dot), most frequent first, and the body size in
instructions of each loop (each predicated backward branch, in address
order; the largest is a persistent kernel's walk over its frames, whose
body is what a warp issues per frame with each inner loop run once).  The
static count also holds the prologue and the out-of-line paths of
divergent shuffles (``BRA.DIV`` targets, which return by unconditional
backward branches: no loops, and never run by a converged warp).  A
loop's body counts once; where a kernel's per-frame work is unrolled (the ladders), the static
count is close to the instructions a warp issues per frame, and a kernel
that issues one warp instruction per clock on each of an SM's 4
schedulers needs at least that count x frames / (4 x SMs x clock).  Runs
on any host: the listing is text.
"""

from __future__ import annotations

import collections
import json
import re
import sys

_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
_BRANCH = re.compile(r"/\*([0-9a-f]{4,})\*/\s+@!?U?P\w+\s+BRA(?:\.[A-Z.]+)?\s+"
                     r"(?:`?\(?)0x([0-9a-f]+)")


def _sections(listing: str):
    for section in re.split(r"\n\s*Function : ", listing)[1:]:
        yield section.split("\n", 1)[0].strip(), section


def kernels(listing: str) -> dict[str, collections.Counter]:
    """{mangled name: Counter of opcodes} of every function in the listing."""
    return {name: collections.Counter(
        op.split(".")[0] for op in _INSTRUCTION.findall(section))
        for name, section in _sections(listing)}


def loops(listing: str) -> dict[str, list[int]]:
    """{mangled name: body sizes} of every function's loops: a predicated
    branch at address a back to t < a closes a loop of (a - t) / 16 + 1
    instructions (16 bytes each)."""
    out = {}
    for name, section in _sections(listing):
        out[name] = [(int(a, 16) - int(t, 16)) // 16 + 1
                     for a, t in _BRANCH.findall(section)
                     if int(t, 16) < int(a, 16)]
    return out


def main(argv: list[str]) -> int:
    if not argv:
        raise SystemExit(__doc__)
    with open(argv[0]) as f:
        listing = f.read()
    found, bodies = kernels(listing), loops(listing)
    for name, ops in found.items():
        if all(s in name for s in argv[1:]):
            print(json.dumps({"kernel": name, "instructions": sum(ops.values()),
                              "opcodes": dict(ops.most_common()),
                              "loops": bodies[name]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
