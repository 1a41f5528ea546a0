"""The traced sub-window: ``torch.profiler`` over a bounded stretch at the
end of a ``--trace 1`` run's window, reduced to the device's busy time (the
union of every CUDA activity: kernels, copies, fills), the traced window's
length, the device operations that took most time and the longest idle
gaps, each named by what the host was doing (the CPU op that overlaps it
most)."""

from __future__ import annotations

import time

import torch

WINDOW_SPAN = "perfbench.window"
TOP = 10


class Profile:
    """The profiler over a run or a part of it, and the stretch of it that
    is summarized: ``start``, ``begin``, ``end``, ``stop``, ``result``."""

    def __init__(self):
        self.summary = None
        self._prof = None
        self._span = None

    def start(self) -> None:
        """Start recording (the stretch is marked by ``begin``/``end``)."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def begin(self) -> None:
        _sync()
        self._t0 = time.perf_counter()
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()

    def end(self) -> None:
        _sync()
        self._span.__exit__(None, None, None)
        self._host_s = time.perf_counter() - self._t0

    def stop(self) -> None:
        self._prof.__exit__(None, None, None)

    def result(self) -> dict:
        """The stretch's summary (its reduction takes a while: a run that
        must not be held up asks for it after its window)."""
        if self.summary is None:
            self.summary = summarize(
                self._prof.profiler.kineto_results.events(), self._host_s)
            self._prof = None
        return self.summary


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _union(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events, host_s: float) -> dict:
    """``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` of the
    traced window, from the profiler's raw events (every thread's: the
    server launches from its own), times in nanoseconds."""
    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events
           if e.name() == WINDOW_SPAN and e.device_type() != cuda]
    if win:
        w0, w1 = win[0].start_ns(), win[0].end_ns()
    dev, cpu, by_name = [], [], {}
    for e in events:
        a, b, name = e.start_ns(), e.end_ns(), e.name()
        if name == WINDOW_SPAN or getattr(e, "is_user_annotation",
                                          lambda: False)():
            continue            # spans, mirrored on the device's timeline
        if e.device_type() == cuda:
            if win:
                a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b))
                by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        else:
            cpu.append((a, b, name))
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) / 1e9
    window_s = (w1 - w0) / 1e9 if win else host_s
    gaps = []
    if win:
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for a, b in gaps[:TOP]:
        best, name = 0.0, "no host op recorded"
        for c0, c1, n in cpu:
            ov = min(b, c1) - max(a, c0)
            if ov > best:
                best, name = ov, n
        idle.append([f"host: {name}", (b - a) / 1e9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_s, "window_s": window_s,
            "device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}
