"""How long a dispatched step waited for ``FeatureServer``'s delivery
thread, in ms, the mean over the window's steps: the change of
``stats()["outq_wait_s"]`` over that of ``stats()["steps"]`` (None where
the server does not count it, or delivered no step)."""


def read(layer):
    st = layer.get("server_stats")
    if not st or not st.get("steps") or "outq_wait_s" not in st:
        return None
    return 1e3 * st["outq_wait_s"] / st["steps"]
