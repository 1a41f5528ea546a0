"""Batched Whisper log-mel over 30 s windows (``WhisperConfig``):
``MFCC(cfg)(audio)`` on (windows, samples) int16 made on the card from the
seed, called back to back over a ring of ``inputs`` batches, as
``batch.py`` runs its loop.  Each window holds speech for a length drawn
from the seed, uniform over [``speech_min_s``, ``speech_max_s``] in whole
samples, and zeros after it, as whisper's ``pad_or_trim`` leaves an
utterance: every call works the log floor and the window's clamp.  The
program is built from the port's fields (``mfcc``); the reference is the
module of ``ref/`` that the configuration names (``reference``:
``whisper_ref``), run on the recipe's options as whisper spells them
(``whisper``), and ``whisper_roofline`` gives the least time of a call.

Traffic parameters: ``windows``, ``samples``, ``speech_min_s``,
``speech_max_s``, ``inputs``, ``trace_seconds``.  ``correct`` compares the
last call's output for every input batch (the window's, or the warm-up's
for a batch a window too short never reached), all windows and frames,
with the reference, computed a block of windows at a time on the card
after the window.  A ``--trace 1`` run also records the recipe's kernel
launches over its calls before the profiled stretch (the program's
``whisper.WHISPER_LAUNCHES`` and ``WHISPER_NORM_LAUNCHES``; nothing where
the program has no such counters)."""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from .. import inputs, whisper_roofline
from ..harness import Check, Outcome
from ..ref import torch_ref
from . import batch
from ._window import Pacer, memory_peak, sync, timed_loop

ROWS = 16     # windows a block of the comparison
COUNTERS = ("WHISPER_LAUNCHES", "WHISPER_NORM_LAUNCHES")


def reference(ctx):
    """The configuration's reference module and its options."""
    ref = importlib.import_module(f"perfbench.ref.{ctx.config['reference']}")
    return ref, ref.options(**ctx.config["whisper"])


def speech_lengths(ctx, i: int) -> np.ndarray:
    """(windows,) samples of speech in input batch ``i``."""
    p = ctx.traffic
    rng = np.random.default_rng(inputs.subseed(ctx.seed, "speech", i))
    return rng.integers(round(p["speech_min_s"] * inputs.RATE),
                        round(p["speech_max_s"] * inputs.RATE) + 1,
                        p["windows"])


def make_inputs(ctx) -> list:
    """The cell's input batches, made on the card from the seed: the bench
    signal, zero past each window's speech."""
    p, dev = ctx.traffic, ctx.device
    out = []
    for i in range(p["inputs"]):
        x = inputs.card_audio(p["windows"], p["samples"], ctx.seed,
                              f"window{i}", dev)
        n = torch.as_tensor(speech_lengths(ctx, i), device=dev)
        x.masked_fill_(torch.arange(p["samples"], device=dev)[None, :]
                       >= n[:, None], 0)
        out.append(x)
    return out


def launches_seen(whisper) -> int | None:
    """The sum of the program's two launch counters, or None without
    them."""
    counts = [getattr(whisper, name, None) for name in COUNTERS]
    return None if None in counts else sum(counts)


def run(ctx) -> Outcome:
    from mfcc_tpu_torch import MFCC
    from mfcc_tpu_torch.config import WhisperConfig
    from mfcc_tpu_torch.ops import whisper

    p, conf, dev = ctx.traffic, ctx.config, ctx.device
    B, T, k = p["windows"], p["samples"], p["inputs"]
    ref, opts = reference(ctx)
    cfg = WhisperConfig(**conf["mfcc"])
    audio = make_inputs(ctx)
    ctx.mark("inputs")
    fe = MFCC(cfg, precision=conf.get("precision", "highest"), device=dev)
    ctx.mark("program")
    last = [None] * k
    for i in range(k):                      # warm up: builds the kernels
        last[i] = fe(audio[i])
    sync(dev)
    ctx.mark("warm-up")
    seen = []                               # the counters before each call

    def issue(n):
        if ctx.trace:
            seen.append(launches_seen(whisper))
        last[n % k] = fe(audio[n % k])

    setup_s = time.perf_counter() - ctx.t_start
    w = timed_loop(ctx, issue, Pacer(dev, every=1, depth=2))
    frames = B * ref.num_frames(T, opts)
    peak = memory_peak(dev)
    before = len(w["host_s"])               # calls before the stretch
    launches = None
    if before and seen[0] is not None:
        after = (seen[before] if before < len(seen)
                 else launches_seen(whisper))
        launches = {"calls": before, "change": after - seen[0]}
    layer = {"call_host_us": [h * 1e6 for h in w["host_s"]],
             "profile": w["profile"], "profiled_calls": w["profiled_calls"],
             "least_s": whisper_roofline.least_s(opts, B, T),
             "launches": launches}
    del fe

    def check():
        return compare(ctx, audio, last)

    return Outcome(
        e2e={"frames_per_s": w["calls"] * frames / w["window_s"],
             "setup_s": setup_s},
        layer=layer, attempted=w["calls"], failed=0,
        memory_peak_bytes=peak, check=check, profile=w["profile"])


def compare(ctx, audio, outs) -> list:
    """The outputs against the reference, a block of windows at a time:
    max-abs where both are finite, and the entries finite in one and not
    in the other."""
    ref, opts = reference(ctx)
    worst, nonfinite = 0.0, 0
    for x, got in zip(audio, outs):
        want_shape = (x.shape[0], opts["n_mels"],
                      ref.num_frames(x.shape[1], opts))
        if got is None or tuple(got.shape) != want_shape:
            return [Check("output_shape_off", 1, 0)]
        for s in range(0, x.shape[0], ROWS):
            e, nf = batch.max_abs(got[s: s + ROWS],
                                  ref.log_mel(x[s: s + ROWS], opts))
            worst, nonfinite = max(worst, e), nonfinite + nf
    return [Check("max_abs_err", worst, ctx.config["limit"]),
            Check("nonfinite_off", nonfinite, 0)]


def tf32_matmul(a, b):
    """A product of float32 operands rounded to TF32 (10 mantissa bits)."""
    return torch_ref.tf32(a) @ torch_ref.tf32(b)


def control(ctx, tf32: bool = True) -> list:
    """The reference in the program's place one precision lower (float32
    throughout, the mel product's operands rounded to TF32), on the cell's
    own inputs and sizes, judged by ``compare``: it has to come out as not
    correct.  ``tf32=False`` reads the reference wholly in float32, TF32
    off: Whisper's own precision."""
    ref, opts = reference(ctx)
    audio = make_inputs(ctx)
    return compare(ctx, audio, [
        ref.log_mel(x, opts, dtype=torch.float32,
                    matmul=tf32_matmul if tf32 else None) for x in audio])
