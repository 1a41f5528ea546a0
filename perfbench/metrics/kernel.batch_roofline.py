"""The batch call's least time (``roofline.batch_call``) over the device's
busy time per call in the profiled stretch: every CUDA activity the calls
issued, whatever kernels implement them.  Nothing when the trace holds no
device activity."""


def read(layer):
    prof, n = layer.get("profile"), layer.get("profiled_calls")
    if not prof or not n or prof["busy_s"] <= 0:
        return None
    return 100.0 * layer["least_s"] / (prof["busy_s"] / n)
