"""K11-norm's share of the card's busy time in the profiled stretch: the
device time of the operations whose name holds ``whisper_norm`` (the
kernel's name is its span) over the union of every CUDA activity the calls
issued.  Nothing where the trace holds no such kernel."""


def read(layer):
    prof = layer.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    norm = sum(s for name, s in prof["device_ops"] if "whisper_norm" in name)
    return 100.0 * norm / prof["busy_s"] if norm > 0 else None
