"""The recipe's kernel launches a call: the change of the program's launch
counter over the traced run's calls before its profiled stretch, divided by
those calls.  1.0 is one kernel a call; 0 is a fall back to the chain (its
torch ops count nothing).  Nothing where the program has no such counter."""


def read(layer):
    n = layer.get("launches")
    if not n or not n["calls"]:
        return None
    return n["change"] / n["calls"]
