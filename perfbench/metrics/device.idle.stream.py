"""The share of the profiled stretch in which nothing ran on the card: 1 -
(the union of every CUDA activity) / (the stretch)."""


def read(layer):
    prof = layer.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
