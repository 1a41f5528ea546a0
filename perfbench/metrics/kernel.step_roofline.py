"""The streaming step's least time (``roofline.stream_step``, counting the
operations of the valid frames) over the device's busy time per step in the
profiled stretch: every CUDA activity the steps issued, whatever kernels
implement them.  Nothing when the trace holds no device activity."""


def read(layer):
    prof, n = layer.get("profile"), layer.get("profiled_calls")
    if not prof or not n or prof["busy_s"] <= 0:
        return None
    return 100.0 * layer["least_s"] / (prof["busy_s"] / n)
