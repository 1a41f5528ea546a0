"""Host microseconds for ``StreamingMFCC.step`` to return (no wait
inside), the median over the traced run's steps before its profiled
stretch."""
import statistics


def read(layer):
    xs = layer.get("step_host_us")
    return statistics.median(xs) if xs else None
