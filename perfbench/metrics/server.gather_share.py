"""The share of the window that ``FeatureServer``'s gather took: the change of
its ``stats()["gather_s"]`` over the window, over the window."""


def read(layer):
    st = layer.get("server_stats")
    if not st:
        return None
    return 100.0 * st["gather_s"] / layer["window_s"]
