"""The share of the window that ``FeatureServer``'s delivery's encode took (the
host view, the mask, the framing, the counters): the change of
``stats()["encode_s"]`` over the window, over the window (None where the
server does not count it)."""


def read(layer):
    st = layer.get("server_stats")
    if not st or "encode_s" not in st:
        return None
    return 100.0 * st["encode_s"] / layer["window_s"]
