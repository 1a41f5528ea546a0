"""What the closed-loop drivers share: a bound on the work queued ahead of
the card, the timed loop with its traced stretch, and the device's peak."""

from __future__ import annotations

import collections
import time

import torch

from ..trace import Profile


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


class Pacer:
    """Keep at most ``depth`` groups of ``every`` calls queued ahead of the
    card: an event after every ``every``-th call, and a wait on the oldest
    once more than ``depth`` are pending.  The host then never blocks
    inside a launch on a full queue, and the window ends close to the host's
    last issue."""

    def __init__(self, device, every: int, depth: int):
        self.cuda = device.type == "cuda"
        self.every, self.depth = every, depth
        self.pending = collections.deque()

    def tick(self, n: int) -> None:
        if not self.cuda or n % self.every:
            return
        ev = torch.cuda.Event()
        ev.record()
        self.pending.append(ev)
        if len(self.pending) > self.depth:
            self.pending.popleft().synchronize()


def timed_loop(ctx, issue, pacer: Pacer) -> dict:
    """Call ``issue(n)`` back to back for ``ctx.seconds`` of host time,
    then wait for the card.  A ``--trace 1`` run times each call's return
    on the host (no wait inside) until its last ``trace_seconds``, which
    run under the profiler (and are kept whole past the window's end, if
    starting the profiler took their time).  Returns the window's seconds, the calls made,
    the host times (s) and the profile."""
    end_traced = ctx.traffic.get("trace_seconds", 0.0) if ctx.trace else 0.0
    host, prof, n, n_prof = [], None, 0, 0
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    prof_at = end - end_traced if ctx.trace else float("inf")
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        if prof is None and now >= prof_at:
            prof = Profile()
            prof.start()            # the profiler's start can take a while
            prof.begin()
            n_prof = n
            end = max(end, time.perf_counter() + end_traced)
        if ctx.trace and prof is None:
            a = time.perf_counter()
            issue(n)
            host.append(time.perf_counter() - a)
        else:
            issue(n)
        n += 1
        pacer.tick(n)
    sync(ctx.device)
    t1 = time.perf_counter()
    summary = None
    if prof is not None:
        prof.end()
        prof.stop()
        summary = prof.result()
    return {"t0": t0, "window_s": t1 - t0, "calls": n, "host_s": host,
            "profile": summary, "profiled_calls": n - n_prof}
