"""The share of the window that ``FeatureServer``'s delivery's ``sendall``s
took: the change of ``stats()["send_s"]`` over the window, over the window
(None where the server does not count it)."""


def read(layer):
    st = layer.get("server_stats")
    if not st or "send_s" not in st:
        return None
    return 100.0 * st["send_s"] / layer["window_s"]
