"""The normalisation kernel's share of its roofline: its least time by
bytes a call (``seamless_roofline.cmvn_least_s``: the own frames' float64
log-mel read and the whole output written once) over its device time a
call in the profiled stretch, the trace's operations whose name holds
``fbank_cmvn`` (the kernel's name is its span).  Nothing where the trace
holds no such kernel."""


def read(layer):
    prof, n = layer.get("profile"), layer.get("profiled_calls")
    if not prof or not n or "cmvn_least_s" not in layer:
        return None
    device_s = sum(s for name, s in prof["device_ops"] if "fbank_cmvn" in name)
    if device_s <= 0:
        return None
    return 100.0 * layer["cmvn_least_s"] / (device_s / n)
