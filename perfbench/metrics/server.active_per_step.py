"""The slots a ``FeatureServer`` step carried, the mean over the window:
the change of ``stats()["chunks"]`` (chunks and flush runs gathered) over
that of ``stats()["steps"]`` (None where the server does not count chunks,
or delivered no step)."""


def read(layer):
    st = layer.get("server_stats")
    if not st or not st.get("steps") or "chunks" not in st:
        return None
    return st["chunks"] / st["steps"]
