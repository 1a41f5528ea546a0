"""Batched SeamlessM4T fbank over ragged utterances
(``SeamlessFbankConfig``): ``MFCC(cfg)(audio, lengths)`` on (utterances,
samples) int16 made on the card from the seed, each utterance zero-padded
at its end, with its length in samples, called back to back over a ring of
``inputs`` batches, as ``batch.py`` runs its loop.  The lengths are the
``utterances`` evenly spaced quantiles of uniform [``min_s``, ``max_s``],
(min + (max - min)(i + 1/2) / utterances) s rounded to whole samples, in
an order the seed permutes for each batch: every seed does the same work,
and a collator's random order pads about half the grid.  The program is
built from the port's fields (``mfcc``); the reference is the module of
``ref/`` that the configuration names (``reference``: ``seamless_ref``),
run on the extractor's options as it spells them (``seamless``), and
``seamless_roofline`` gives the least time of a call and of its
normalisation.

Traffic parameters: ``utterances``, ``samples``, ``min_s``, ``max_s``,
``inputs``, ``trace_seconds``.  ``frames_per_s`` counts the utterances' own
frames.  ``correct`` compares the last call's output for every input batch
(the window's, or the warm-up's for a batch a window too short never
reached) with the reference on every own frame, the mask whole, and the
padding entries with exact zeros.  A ``--trace 1`` run also records, over
its calls before the profiled stretch, the recipe's kernel launches (the
program's ``seamless.FBANK_LAUNCHES`` and ``CMVN_LAUNCHES``) and the frames
its walk computed (``seamless.FBANK_FRAMES``) beside the own frames;
nothing where the program has no such counters."""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from .. import inputs, seamless_roofline
from ..harness import Check, Outcome
from ..ref import torch_ref
from . import batch
from ._window import Pacer, memory_peak, sync, timed_loop

LAUNCH_COUNTERS = ("FBANK_LAUNCHES", "CMVN_LAUNCHES")


def reference(ctx):
    """The configuration's reference module and its options."""
    ref = importlib.import_module(f"perfbench.ref.{ctx.config['reference']}")
    return ref, ref.options(**ctx.config["seamless"])


def lengths(ctx, i: int) -> np.ndarray:
    """(utterances,) int64 samples of each utterance of input batch ``i``."""
    p = ctx.traffic
    B = p["utterances"]
    q = p["min_s"] + (p["max_s"] - p["min_s"]) * (np.arange(B) + 0.5) / B
    rng = np.random.default_rng(inputs.subseed(ctx.seed, "order", i))
    return rng.permutation(np.round(q * inputs.RATE).astype(np.int64))


def make_inputs(ctx) -> tuple[list, list]:
    """The cell's input batches, made on the card from the seed (the bench
    signal, zero past each utterance's length), and their lengths as CPU
    int64 tensors, as a collator hands them over."""
    p, dev = ctx.traffic, ctx.device
    audio, lens = [], []
    for i in range(p["inputs"]):
        x = inputs.card_audio(p["utterances"], p["samples"], ctx.seed,
                              f"utterance{i}", dev)
        n = torch.from_numpy(lengths(ctx, i))
        x.masked_fill_(torch.arange(p["samples"], device=dev)[None, :]
                       >= n.to(dev)[:, None], 0)
        audio.append(x)
        lens.append(n)
    return audio, lens


def counters(seamless) -> tuple | None:
    """(launches, frames computed) of the program's counters, or None
    without them."""
    got = [getattr(seamless, name, None)
           for name in (*LAUNCH_COUNTERS, "FBANK_FRAMES")]
    return None if None in got else (got[0] + got[1], got[2])


def run(ctx) -> Outcome:
    from mfcc_tpu_torch import MFCC
    from mfcc_tpu_torch.config import SeamlessFbankConfig
    from mfcc_tpu_torch.ops import seamless

    p, conf, dev = ctx.traffic, ctx.config, ctx.device
    k = p["inputs"]
    ref, opts = reference(ctx)
    cfg = SeamlessFbankConfig(**conf["mfcc"])
    audio, lens = make_inputs(ctx)
    own = [sum(ref.num_frames(int(n), opts) for n in n_i) for n_i in lens]
    ctx.mark("inputs")
    fe = MFCC(cfg, precision=conf.get("precision", "highest"), device=dev)
    ctx.mark("program")
    last = [None] * k
    for i in range(k):                      # warm up: builds the kernels
        last[i] = fe(audio[i], lens[i])
    sync(dev)
    ctx.mark("warm-up")
    seen = []                               # the counters before each call

    def issue(n):
        if ctx.trace:
            seen.append(counters(seamless))
        last[n % k] = fe(audio[n % k], lens[n % k])

    setup_s = time.perf_counter() - ctx.t_start
    w = timed_loop(ctx, issue, Pacer(dev, every=1, depth=2))
    done = sum(own[n % k] for n in range(w["calls"]))
    peak = memory_peak(dev)
    before = len(w["host_s"])               # calls before the stretch
    launches = frames = None
    if before and seen[0] is not None:
        after = seen[before] if before < len(seen) else counters(seamless)
        launches = {"calls": before, "change": after[0] - seen[0][0]}
        frames = {"computed": after[1] - seen[0][1],
                  "own": sum(own[n % k] for n in range(before))}
    layer = {"call_host_us": [h * 1e6 for h in w["host_s"]],
             "profile": w["profile"], "profiled_calls": w["profiled_calls"],
             "least_s": seamless_roofline.least_s(opts, lens[0].tolist()),
             "cmvn_least_s": seamless_roofline.cmvn_least_s(
                 opts, lens[0].tolist()),
             "launches": launches, "frames": frames}
    del fe

    def check():
        return compare(ctx, audio, lens, last)

    return Outcome(
        e2e={"frames_per_s": done / w["window_s"], "setup_s": setup_s},
        layer=layer, attempted=w["calls"], failed=0,
        memory_peak_bytes=peak, check=check, profile=w["profile"])


def compare(ctx, audio, lens, outs) -> list:
    """Each batch's (features, mask) against the reference: max-abs over
    the own frames where both are finite, the entries finite in one and
    not in the other, the mask entries off, and the padding entries that
    are not exactly 0."""
    ref, opts = reference(ctx)
    nb = opts["num_mel_bins"]
    worst, nonfinite, mask_off, padding_off = 0.0, 0, 0, 0
    for x, n, got in zip(audio, lens, outs):
        want, want_mask = ref.features(x, n, opts)
        if (got is None or len(got) != 2
                or tuple(got[0].shape) != tuple(want.shape)
                or tuple(got[1].shape) != tuple(want_mask.shape)):
            return [Check("output_shape_off", 1, 0)]
        B, Fp = x.shape[0], want.shape[1] * opts["stride"]
        g, w = got[0].reshape(B, Fp, nb), want.reshape(B, Fp, nb)
        counts = torch.tensor([ref.num_frames(int(v), opts) for v in n],
                              device=g.device)
        own = torch.arange(Fp, device=g.device)[None, :] < counts[:, None]
        e, nf = batch.max_abs(g[own], w[own])
        worst, nonfinite = max(worst, e), nonfinite + nf
        padding_off += int((g[~own] != 0).sum())
        mask_off += int((got[1].to(want_mask.dtype) != want_mask).sum())
    return [Check("max_abs_err", worst, ctx.config["limit"]),
            Check("nonfinite_off", nonfinite, 0),
            Check("mask_off", mask_off, 0),
            Check("padding_off", padding_off, 0),
            Check("output_shape_off", 0, 0)]


def tf32_matmul(a, b):
    """A product of float32 operands rounded to TF32 (10 mantissa bits)."""
    return torch_ref.tf32(a) @ torch_ref.tf32(b)


def control(ctx, tf32: bool = True, fft: bool = False) -> list:
    """The reference in the program's place one precision lower (float32
    throughout, every product's operands rounded to TF32), on the cell's
    own inputs and sizes, judged by ``compare``: it has to come out as not
    correct.  ``tf32=False`` reads the reference wholly in float32, TF32
    off: the extractor's own precision for its statistics; ``fft=True``
    takes its spectrum by ``torch.fft.rfft`` in complex64, the program's
    algorithm one precision down."""
    ref, opts = reference(ctx)
    audio, lens = make_inputs(ctx)
    mm = tf32_matmul if tf32 else torch.matmul
    return compare(ctx, audio, lens, [
        ref.features(x, n, opts, dtype=torch.float32, matmul=mm, fft=fft)
        for x, n in zip(audio, lens)])
