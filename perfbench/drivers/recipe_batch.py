"""Batch corpus extraction in Kaldi's recipe (``KaldiConfig``):
``MFCC(cfg)(audio)`` on (streams, samples) int16 made on the card from the
seed, called back to back over a ring of ``inputs`` batches, as
``batch.py`` runs its loop.  The program is built from the port's fields
(``mfcc``); the reference is the module of ``ref/`` that the configuration
names (``reference``: ``kaldi_ref``), run on the recipe's options as Kaldi
spells them (``kaldi``), and ``kaldi_roofline`` gives the least time of a
call.

Traffic parameters: ``streams``, ``samples``, ``inputs``, ``trace_seconds``.
``correct`` compares the last timed call's output for every input batch,
all streams and frames, with the reference, computed a block of streams at
a time on the card after the window.  A ``--trace 1`` run also records the
recipe's kernel launches over its calls before the profiled stretch (the
program's ``fladder.KALDI_LAUNCHES``; nothing where the program has no such
counter)."""

from __future__ import annotations

import importlib
import time

import torch

from .. import kaldi_roofline
from ..harness import Check, Outcome
from ..ref import torch_ref
from . import batch
from ._window import Pacer, memory_peak, sync, timed_loop

ROWS = 256    # streams a block of the comparison


def reference(ctx):
    """The configuration's reference module and its options."""
    ref = importlib.import_module(f"perfbench.ref.{ctx.config['reference']}")
    return ref, ref.options(**ctx.config["kaldi"])


def run(ctx) -> Outcome:
    from mfcc_tpu_torch import MFCC
    from mfcc_tpu_torch.config import KaldiConfig
    from mfcc_tpu_torch.ops import fladder

    p, conf, dev = ctx.traffic, ctx.config, ctx.device
    S, T, k = p["streams"], p["samples"], p["inputs"]
    ref, opts = reference(ctx)
    cfg = KaldiConfig(**conf["mfcc"])
    audio = batch.make_inputs(ctx)
    ctx.mark("inputs")
    fe = MFCC(cfg, precision=conf.get("precision", "highest"), device=dev)
    ctx.mark("program")
    last = [None] * k
    for i in range(k):                      # warm up: builds the kernels
        fe(audio[i])
    sync(dev)
    ctx.mark("warm-up")
    seen = []                               # the counter before each call

    def issue(n):
        if ctx.trace:
            seen.append(getattr(fladder, "KALDI_LAUNCHES", None))
        last[n % k] = fe(audio[n % k])

    setup_s = time.perf_counter() - ctx.t_start
    w = timed_loop(ctx, issue, Pacer(dev, every=1, depth=2))
    frames = S * ref.num_frames(T, opts)
    peak = memory_peak(dev)
    before = len(w["host_s"])               # calls before the stretch
    launches = None
    if before and seen[0] is not None:
        after = (seen[before] if before < len(seen)
                 else fladder.KALDI_LAUNCHES)
        launches = {"calls": before, "change": after - seen[0]}
    layer = {"call_host_us": [h * 1e6 for h in w["host_s"]],
             "profile": w["profile"], "profiled_calls": w["profiled_calls"],
             "least_s": kaldi_roofline.least_s(opts, S, T), "launches": launches}
    del fe

    def check():
        return compare(ctx, audio, last)

    return Outcome(
        e2e={"frames_per_s": w["calls"] * frames / w["window_s"],
             "setup_s": setup_s},
        layer=layer, attempted=w["calls"], failed=0,
        memory_peak_bytes=peak, check=check, profile=w["profile"])


def compare(ctx, audio, outs) -> list:
    """The outputs against the reference, a block of streams at a time:
    max-abs where both are finite, and the entries finite in one and not
    in the other."""
    ref, opts = reference(ctx)
    worst, nonfinite = 0.0, 0
    for x, got in zip(audio, outs):
        want_shape = (x.shape[0], ref.num_frames(x.shape[1], opts),
                      opts["num_ceps"])
        if got is None or tuple(got.shape) != want_shape:
            return [Check("output_shape_off", 1, 0)]
        for s in range(0, x.shape[0], ROWS):
            e, nf = batch.max_abs(got[s: s + ROWS],
                                  ref.mfcc(x[s: s + ROWS], opts))
            worst, nonfinite = max(worst, e), nonfinite + nf
    return [Check("max_abs_err", worst, ctx.config["limit"]),
            Check("nonfinite_off", nonfinite, 0)]


def tf32_matmul(a, b):
    """A product of float32 operands rounded to TF32 (10 mantissa bits)."""
    return torch_ref.tf32(a) @ torch_ref.tf32(b)


def control(ctx) -> list:
    """The reference in the program's place one precision lower (float32
    with TF32 operands), on the cell's own inputs and sizes, judged by
    ``compare``: it has to come out as not correct."""
    ref, opts = reference(ctx)
    audio = batch.make_inputs(ctx)
    return compare(ctx, audio, [ref.mfcc(x, opts, dtype=torch.float32,
                                         matmul=tf32_matmul)
                                for x in audio])
