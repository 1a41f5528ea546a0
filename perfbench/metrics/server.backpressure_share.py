"""The share of the window that ``FeatureServer``'s stepper spent blocked on a
full queue of dispatched steps: the change of ``stats()["backpressure_s"]``
over the window, over the window (None where the server does not count it)."""


def read(layer):
    st = layer.get("server_stats")
    if not st or "backpressure_s" not in st:
        return None
    return 100.0 * st["backpressure_s"] / layer["window_s"]
