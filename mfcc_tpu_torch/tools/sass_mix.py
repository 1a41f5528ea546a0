"""Count each kernel's SASS instructions by opcode, from a ``cuobjdump``
listing of one of the built libraries.

    cuobjdump -sass mfcc_tpu_torch/_build/libint_mfcc-<hash>.so > int.sass
    python3 mfcc_tpu_torch/tools/sass_mix.py int.sass [SUBSTRING ...]

Prints one JSON line per kernel of the listing (each ``Function :``
section whose mangled name contains every SUBSTRING given): the name, the
kernel's static instruction count, and the count of each opcode (the
mnemonic before its first dot), most frequent first.  A loop's body counts
once; where a kernel's per-frame work is unrolled (the ladders), the static
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


def kernels(listing: str) -> dict[str, collections.Counter]:
    """{mangled name: Counter of opcodes} of every function in the listing."""
    out = {}
    for section in re.split(r"\n\s*Function : ", listing)[1:]:
        name = section.split("\n", 1)[0].strip()
        out[name] = collections.Counter(
            op.split(".")[0] for op in _INSTRUCTION.findall(section))
    return out


def main(argv: list[str]) -> int:
    if not argv:
        raise SystemExit(__doc__)
    with open(argv[0]) as f:
        found = kernels(f.read())
    for name, ops in found.items():
        if all(s in name for s in argv[1:]):
            print(json.dumps({"kernel": name, "instructions": sum(ops.values()),
                              "opcodes": dict(ops.most_common())}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
