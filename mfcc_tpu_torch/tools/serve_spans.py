"""The serving benchmark's load against a ``FeatureServer`` with its span
ring on, and what the server's counters and spans say about it.

    python3 -m mfcc_tpu_torch.tools.serve_spans --seed 7 [--capacity N]
    python3 -m mfcc_tpu_torch.tools.serve_spans --seed 7 --trace --out DIR

Each call is one run of ``perfbench``'s ``int.serve`` cell (its open-loop
clients in a process of their own, its window, its ``correct``), with the
server made with ``trace_capacity=N`` (0: the spans off, as the benchmark
runs it).  It prints one JSON line: the cell's result, and every counter of
``stats()`` over the window as a share of it.  Run it in turns with
``--capacity 0`` and without, to see what the spans cost.

With ``--trace`` the run is the cell's ``--trace 1`` run (``torch.profiler``
started before the server exists, its last seconds the profiled stretch);
the line adds, from the spans: a chunk's path through the server (median
and p95 of each part) over the window before the stretch and over the
stretch; the stretch's longest device idle gaps, each with the share of
it that each server thread's phases cover; and how far the spans' clock
lies from the profiler's (``record_function`` probes between two
``perf_counter_ns`` stamps, when the server is made and at the end; the
card's kernels against their launches; the launches against the stepper's
spans).  The line goes to DIR/summary_<seed>.json as well, and the
stretch's timeline (the profiler's events and the server's spans) to
DIR/stretch_<seed>.json.gz.

A measuring tool: it reaches the cell through ``perfbench``'s harness and
gives the server its ring by wrapping the class that the cell's
``perfbench.drivers.serve`` makes.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import time

import numpy as np

T_START = time.perf_counter()
PATH = ("slot_wait", "gather", "dispatch", "outq_wait", "readback_wait",
        "before_send", "encode", "send")
PROBES = 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--capacity", type=int, default=1 << 21,
                    help="spans the server keeps (0: none)")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--out", default="serve_spans_out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clients", type=int,
                    help="in place of the cell's (a small rehearsal)")
    args = ap.parse_args(argv)

    import torch
    import mfcc_tpu_torch
    from perfbench import harness
    from perfbench import trace as ptrace
    from perfbench.drivers import serve as serve_cell

    made, profiles, outcomes, probes = [], [], [], {}

    # with --capacity 0 the server is made as the benchmark makes it (also
    # a server that has no span ring)
    ring = {"trace_capacity": args.capacity} if args.capacity else {}

    class Traced(mfcc_tpu_torch.FeatureServer):
        def __init__(self, *a, **k):
            super().__init__(*a, **ring, **k)
            made.append(self)
            if profiles and getattr(self, "_spans", None) is not None:
                probes["made"] = _probe(self)

    class Kept(ptrace.Profile):
        def __init__(self):
            super().__init__()
            profiles.append(self)

        def stop(self):
            if made and getattr(made[0], "_spans", None) is not None:
                probes["end"] = _probe(made[0])
            super().stop()

        def result(self):
            self.kept = self._prof
            return super().result()

    run = serve_cell.run

    def kept_run(ctx):
        outcomes.append(run(ctx))
        return outcomes[-1]

    mfcc_tpu_torch.FeatureServer = Traced
    serve_cell.Profile, serve_cell.run = Kept, kept_run
    bench = harness.load_benchmark()
    overrides = {"clients": args.clients,
                 "sample_clients": min(args.clients, 16)} \
        if args.clients else None
    dev = torch.device(args.device)
    res = harness.run_cell(bench, "int.serve", args.seed, args.seconds,
                           args.trace, dev, T_START, overrides)
    layer = outcomes[0].layer
    st, win = layer["server_stats"], layer["window_s"]
    line = {"seed": args.seed, "capacity": args.capacity,
            "trace": args.trace, "correct": res["correct"],
            "device": res["device"], "metrics": {
                k: v["value"] for k, v in res["metrics"].items()},
            "load": res.get("load"), "window_s": win,
            "shares": {k: 100.0 * v / win for k, v in st.items()
                       if k.endswith("_s")},
            "counts": {k: v for k, v in st.items()
                       if not k.endswith("_s")}}
    if args.trace:
        line.update(analyse(profiles[0].kept, made[0], probes,
                            args.seconds, args.out, args.seed))
    text = json.dumps(line)
    if args.trace:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"summary_{args.seed}.json"),
                  "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


def _probe(server) -> list:
    """``record_function`` spans between two ``perf_counter_ns`` stamps,
    the stamps on the epoch clock by the server's ring anchor."""
    from torch.profiler import record_function
    out = []
    for _ in range(PROBES):
        p0 = time.perf_counter_ns()
        with record_function("serve_spans.probe"):
            pass
        p1 = time.perf_counter_ns()
        out.append((p0 + server._spans.offset_ns,
                    p1 + server._spans.offset_ns))
    return out


def _q(values) -> dict:
    v = np.asarray(values, dtype=float)
    if not len(v):
        return {"n": 0}
    return {"n": int(len(v)), "p50": float(np.percentile(v, 50)),
            "p95": float(np.percentile(v, 95)), "max": float(v.max())}


def analyse(prof, server, probes, seconds, out_dir, seed) -> dict:
    from mfcc_tpu_torch.examples.server_loadtest import (DEVICE_CATS,
                                                         idle_gaps)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"profile_{seed}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = trace["traceEvents"]
    spans = server.trace_events(base)
    (win,) = [e for e in events if e.get("name") == "perfbench.window"
              and e.get("cat") == "user_annotation"]
    lo, hi = win["ts"], win["ts"] + win["dur"]
    w0 = hi - seconds * 1e6                   # the window's start
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    idle, gaps = idle_gaps(device, spans, lo, hi, top=12)
    out = {"base_ns": base, "stretch_s": (hi - lo) / 1e6,
           "stretch_idle": idle,
           "idle_gaps": [{"at_s": (a - lo) / 1e6, "ms": d / 1e3,
                          "cover": {t: [[n, round(s, 3)] for n, s in ph]
                                    for t, ph in c.items()}}
                         for a, d, c in gaps],
           "path_window": chunk_path(spans, w0, lo),
           "path_stretch": chunk_path(spans, lo, hi),
           "clock": clock(events, spans, probes, base)}
    keep = [e for e in events + spans if e.get("ph") == "M"
            or lo <= e.get("ts", lo) <= hi]
    with gzip.open(os.path.join(out_dir, f"stretch_{seed}.json.gz"),
                   "wt") as f:
        json.dump({"traceEvents": keep, "baseTimeNanoseconds": base}, f)
    return out


def chunk_path(spans, lo, hi) -> dict:
    """The parts of the path of each chunk whose send ended in [lo, hi]
    (ms): its wait whole in its slot; the rest of its step's gather; the
    dispatch; the step's wait in the queue (from its dispatch, the
    stepper's backpressure within it); the readback wait; the delivery's
    work on the step's earlier slots; its own encode and send.  They add
    up to the chunk's span, ``total``."""
    xs = [e for e in spans if e["ph"] == "X"]
    step = {}
    for e in xs:
        if e["name"] in ("gather", "dispatch", "outq_wait",
                         "readback_wait") and "step" in e["args"]:
            step[(e["name"], e["args"]["step"])] = e
    kids = {}
    for e in xs:
        if "parent" in e["args"] and e["name"] in ("slot_wait", "encode",
                                                   "send"):
            kids.setdefault(e["args"]["parent"], {})[e["name"]] = e
    parts = {k: [] for k in PATH + ("total",)}
    for c in xs:
        if c["name"] != "chunk" or not lo <= c["ts"] + c["dur"] <= hi:
            continue
        k, s = kids.get(c["args"]["id"], {}), c["args"]["step"]
        g, d = step.get(("gather", s)), step.get(("dispatch", s))
        q, r = step.get(("outq_wait", s)), step.get(("readback_wait", s))
        if not (g and d and q and r and "send" in k):
            continue
        end = lambda e: e["ts"] + e["dur"]          # noqa: E731
        sw, enc, snd = k["slot_wait"], k["encode"], k["send"]
        for name, v in (("slot_wait", sw["dur"]),
                        ("gather", end(g) - end(sw)),
                        ("dispatch", d["dur"]), ("outq_wait", q["dur"]),
                        ("readback_wait", end(r) - end(q)),
                        ("before_send", enc["ts"] - end(r)),
                        ("encode", enc["dur"]), ("send", snd["dur"]),
                        ("total", c["dur"])):
            parts[name].append(v / 1e3)
    return {k: _q(v) for k, v in parts.items()}


def clock(events, spans, probes, base) -> dict:
    """How far the spans' clock lies from the profiler's: each probe's
    ``record_function`` start after its first stamp and end before its
    second (µs; both above 0 when the clocks agree); each kernel's start
    after its launch; each CUDA runtime call of the stepper thread inside
    a stepper span (the least margin at either end, µs)."""
    out = {}
    recs = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("name") == "serve_spans.probe")
    stamps = sorted((a - base) / 1e3 for a, _ in
                    probes.get("made", []) + probes.get("end", []))
    ends = sorted((b - base) / 1e3 for _, b in
                  probes.get("made", []) + probes.get("end", []))
    if recs and len(recs) == len(stamps):
        out["probe_start_after_us"] = _q([r[0] - s for r, s in
                                          zip(recs, stamps)])
        out["probe_end_before_us"] = _q([e - r[1] for r, e in
                                         zip(recs, ends)])
        n = len(probes.get("made", []))
        out["probe_drift_us"] = float(
            np.median([r[0] - s for r, s in zip(recs[n:], stamps[n:])])
            - np.median([r[0] - s for r, s in zip(recs[:n], stamps[:n])])
        ) if n and len(recs) > n else None
    launch = {e["args"].get("correlation"): e for e in events
              if e.get("cat") == "cuda_runtime" and "args" in e}
    lag = [e["ts"] - launch[e["args"]["correlation"]]["ts"]
           for e in events if e.get("cat") == "kernel"
           and e.get("args", {}).get("correlation") in launch]
    out["kernel_after_launch_us"] = _q(lag)
    names = {e["tid"]: e["args"]["name"] for e in spans if e["ph"] == "M"}
    stepper = [t for t, n in names.items() if n == "FeatureServer stepper"]
    if stepper:
        mine = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                      if e["ph"] == "X" and e["tid"] == stepper[0]
                      and e["name"] != "dispatch")
        s0 = np.array([a for a, _ in mine])
        s1 = np.array([b for _, b in mine])
        inside, margins = 0, []
        calls = [e for e in events if e.get("cat") == "cuda_runtime"
                 and e.get("tid") == stepper[0]]
        for e in calls:
            k = np.searchsorted(s0, e["ts"], side="right") - 1
            if k >= 0 and e["ts"] + e["dur"] <= s1[k]:
                inside += 1
                margins.append(min(e["ts"] - s0[k],
                                   s1[k] - e["ts"] - e["dur"]))
        out["stepper_runtime_calls"] = len(calls)
        out["inside_stepper_spans"] = inside
        out["inside_margin_us"] = _q(margins)
    return out


if __name__ == "__main__":
    raise SystemExit(main())
