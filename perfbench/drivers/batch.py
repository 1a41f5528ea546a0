"""Batch corpus extraction: ``MFCC()(audio)`` or ``MFCC().int(audio)`` on
(streams, samples) int16 made on the card from the seed, called back to back
(a closed loop) over a ring of ``inputs`` batches, so that consecutive calls
read different audio.

Traffic parameters: ``streams``, ``samples``, ``inputs``, ``trace_seconds``.
``correct`` compares the last timed call's output for every input batch,
all streams and frames, with the plain reference."""

from __future__ import annotations

import time

import torch

from .. import inputs, roofline
from ..harness import Check, Outcome
from ..ref import torch_ref
from ._window import Pacer, memory_peak, sync, timed_loop


def run(ctx) -> Outcome:
    from mfcc_tpu_torch import MFCC

    p, conf, dev = ctx.traffic, ctx.config, ctx.device
    S, T, k = p["streams"], p["samples"], p["inputs"]
    cfg = ctx.program_config()
    audio = make_inputs(ctx)
    ctx.mark("inputs")
    fe = MFCC(cfg, precision=conf.get("precision", "highest"), device=dev)
    call = fe.int if conf["path"] == "int" else fe
    ctx.mark("program")
    last = [None] * k
    for i in range(k):                      # warm up: builds the kernels
        call(audio[i])
    sync(dev)
    ctx.mark("warm-up")

    def issue(n):
        last[n % k] = call(audio[n % k])

    setup_s = time.perf_counter() - ctx.t_start
    w = timed_loop(ctx, issue, Pacer(dev, every=1, depth=2))
    frames = S * cfg.n_frames(T)
    peak = memory_peak(dev)
    least_s, _ = roofline.batch_call(ctx.ref_config(), conf["path"], S, T)
    layer = {"call_host_us": [h * 1e6 for h in w["host_s"]],
             "profile": w["profile"], "profiled_calls": w["profiled_calls"],
             "least_s": least_s}
    del fe, call

    def check():
        return compare(ctx, audio, last)

    return Outcome(
        e2e={"frames_per_s": w["calls"] * frames / w["window_s"],
             "setup_s": setup_s},
        layer=layer, attempted=w["calls"], failed=0,
        memory_peak_bytes=peak, check=check, profile=w["profile"])


def make_inputs(ctx) -> list:
    """The cell's input batches, made on the card from the seed."""
    p = ctx.traffic
    return [inputs.card_audio(p["streams"], p["samples"], ctx.seed,
                              f"batch{i}", ctx.device)
            for i in range(p["inputs"])]


def compare(ctx, audio, outs) -> list:
    """The outputs against the reference, a block of streams at a time."""
    cfg = ctx.ref_config()
    int_path = ctx.config["path"] == "int"
    off = nonfinite = 0
    worst = 0.0
    tables = torch_ref.IntTables(cfg, ctx.device) if int_path else None
    rows = 64
    for x, got in zip(audio, outs):
        if got is None or tuple(got.shape) != (x.shape[0], cfg.n_frames(
                x.shape[1]), cfg.nceptrums):
            return [Check("output_shape_off", 1, 0)]
        for s in range(0, x.shape[0], rows):
            g = got[s: s + rows]
            if int_path:
                want = torch_ref.mfcc_int(x[s: s + rows], cfg,
                                          int_tables=tables)
                off += int((g.to(torch.int64) != want).sum())
            else:
                e, nf = max_abs(g, torch_ref.mfcc_float(x[s: s + rows], cfg))
                worst, nonfinite = max(worst, e), nonfinite + nf
    if int_path:
        return [Check("elements_off", off, ctx.config["limit"])]
    return [Check("max_abs_err", worst, ctx.config["limit"]),
            Check("nonfinite_off", nonfinite, 0)]


def max_abs(got: torch.Tensor, want: torch.Tensor) -> tuple[float, int]:
    """(max |got - want| where both are finite, the entries finite in one
    and not in the other)."""
    g, w = got.to(torch.float64), want.to(torch.float64)
    fg, fw = torch.isfinite(g), torch.isfinite(w)
    both = fg & fw
    err = float((g[both] - w[both]).abs().max()) if bool(both.any()) else 0.0
    return err, int((fg != fw).sum())

