"""The CPU time of ``FeatureServer``'s three threads (stepper, delivery,
reader) over the window, as a share of one core: the change of the sum of
its ``stats()["*_cpu_s"]`` over the window, over the window (None where the
server does not count it)."""

KEYS = ("stepper_cpu_s", "delivery_cpu_s", "reader_cpu_s")


def read(layer):
    st = layer.get("server_stats")
    if not st or not all(k in st for k in KEYS):
        return None
    return 100.0 * sum(st[k] for k in KEYS) / layer["window_s"]
