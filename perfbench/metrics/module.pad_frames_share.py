"""The share of the frames the recipe's walk computed that are no
utterance's own: (frames computed - own frames) / frames computed over the
traced run's calls before its profiled stretch, from the program's frame
counter.  0 when the walk skips the padding; a walk over the padded grid
reads the padding's share of it.  Nothing where the program has no such
counter."""


def read(layer):
    n = layer.get("frames")
    if not n or n["computed"] <= 0:
        return None
    return 100.0 * (n["computed"] - n["own"]) / n["computed"]
