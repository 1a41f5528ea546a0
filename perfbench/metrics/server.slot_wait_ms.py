"""How long a chunk waited whole in its slot before ``FeatureServer``'s
stepper gathered it, in ms, the mean over the window's chunks: the change
of ``stats()["slot_wait_s"]`` over that of ``stats()["chunks"]`` (None
where the server does not count them, or gathered none)."""


def read(layer):
    st = layer.get("server_stats")
    if not st or not st.get("chunks") or "slot_wait_s" not in st:
        return None
    return 1e3 * st["slot_wait_s"] / st["chunks"]
