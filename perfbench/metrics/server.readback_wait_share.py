"""The share of the window that ``FeatureServer``'s delivery spent waiting on
each step's event (the card and the copy back): the change of
``stats()["readback_wait_s"]`` over the window, over the window (None where
the server does not count it)."""


def read(layer):
    st = layer.get("server_stats")
    if not st or "readback_wait_s" not in st:
        return None
    return 100.0 * st["readback_wait_s"] / layer["window_s"]
