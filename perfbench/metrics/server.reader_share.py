"""The share of the window that ``FeatureServer``'s reader took outside
``select`` (accept, recv, decode, split): the change of
``stats()["reader_s"]`` over the window, over the window (None where the
server does not count it)."""


def read(layer):
    st = layer.get("server_stats")
    if not st or "reader_s" not in st:
        return None
    return 100.0 * st["reader_s"] / layer["window_s"]
