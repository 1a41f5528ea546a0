"""The share of the window that ``FeatureServer``'s stepper's dispatch took
(the step, the rollback, the wire's conversion and copy back, enqueued): the
change of ``stats()["compute_s"]`` over the window, over the window (None
where the server does not count it)."""


def read(layer):
    st = layer.get("server_stats")
    if not st or "compute_s" not in st:
        return None
    return 100.0 * st["compute_s"] / layer["window_s"]
