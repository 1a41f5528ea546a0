"""Real-time capacity for audio already on the card: ``StreamingMFCC.step``
on (streams, chunk) int16 back to back, the state threaded from each step
into the next.  Step k reads chunk k mod ``ring_chunks`` of a seeded ring of
audio made on the card, so no two consecutive steps read the same chunk and
each stream is one continuous signal, the ring repeated.

Traffic parameters: ``streams``, ``chunk``, ``ring_chunks``, ``keep``
(steps drawn from the seed among the first 4,096 whose outputs are kept
beside the first and the last two), ``trace_seconds``.  ``correct``
compares the kept steps' features and masks, every stream, with the plain
reference run on each stream's audio up to that step."""

from __future__ import annotations

import collections
import random
import time

import torch

from .. import inputs, roofline
from ..harness import Check, Outcome
from ..ref import torch_ref
from .batch import max_abs
from ._window import Pacer, memory_peak, sync, timed_loop


def frames_done(cfg, n: int) -> int:
    """Frames complete once ``n`` samples of a stream have arrived."""
    return 0 if n < cfg.windowlen else (n - cfg.windowlen) // cfg.hop + 1


def run(ctx) -> Outcome:
    from mfcc_tpu_torch import StreamingMFCC

    p, conf, dev = ctx.traffic, ctx.config, ctx.device
    S, C, R = p["streams"], p["chunk"], p["ring_chunks"]
    cfg = ctx.program_config()
    ring = make_ring(ctx)
    ctx.mark("inputs")
    sm = StreamingMFCC(cfg, int_path=conf["path"] == "int",
                       precision=conf.get("precision", "highest"),
                       device=dev)
    ctx.mark("program")
    state = sm.init(S)
    for k in range(2):                      # warm up: builds the kernels
        _, _, state = sm.step(ring[k], state)
    sync(dev)
    ctx.mark("warm-up")
    keep = keep_steps(ctx)
    kept, tail = {}, collections.deque(maxlen=2)
    box = [sm.init(S)]

    def issue(k):
        feats, mask, box[0] = sm.step(ring[k % R], box[0])
        if k in keep:
            kept[k] = (feats, mask)
        tail.append((k, feats, mask))

    setup_s = time.perf_counter() - ctx.t_start
    w = timed_loop(ctx, issue, Pacer(dev, every=16, depth=4))
    peak = memory_peak(dev)
    for k, feats, mask in tail:
        kept[k] = (feats, mask)
    rc = ctx.ref_config()
    slots = kept[0][1].shape[1]
    valid = S * frames_done(rc, C * 4096) / 4096    # a step's, on average
    least_s, _ = roofline.stream_step(rc, conf["path"], S, C, valid, slots)
    layer = {"step_host_us": [h * 1e6 for h in w["host_s"]],
             "profile": w["profile"], "profiled_calls": w["profiled_calls"],
             "least_s": least_s}
    del sm, state, box

    def check():
        return compare(ctx, ring, kept)

    return Outcome(
        e2e={"realtime_streams": S * C * w["calls"] / rc.samplerate
             / w["window_s"], "setup_s": setup_s},
        layer=layer, attempted=w["calls"], failed=0,
        memory_peak_bytes=peak, check=check, profile=w["profile"])


def make_ring(ctx):
    """(ring_chunks, streams, chunk) int16 on the card from the seed: each
    stream's signal cut into the chunks that the steps read in turn."""
    p = ctx.traffic
    S, C, R = p["streams"], p["chunk"], p["ring_chunks"]
    return (inputs.card_audio(S, R * C, ctx.seed, "ring", ctx.device)
            .reshape(S, R, C).permute(1, 0, 2).contiguous())


def keep_steps(ctx) -> set:
    """Step 0 and ``keep`` steps drawn from the seed among 1..4095."""
    rng = random.Random(inputs.subseed(ctx.seed, "keep"))
    return set(rng.sample(range(1, 4096), ctx.traffic["keep"])) | {0}


def step_audio(ring: torch.Tensor, start: int, end: int):
    """(S, end - start) samples of every stream from global sample
    ``start``, and (S,) the sample before it (0 at the stream's start)."""
    R, S, C = ring.shape
    t = torch.arange(start - 1, end, device=ring.device)
    seg = ring[(t.clamp_min(0) // C) % R, :, t.clamp_min(0) % C].T
    prev = seg[:, 0] if start > 0 else torch.zeros_like(seg[:, 0])
    return seg[:, 1:], prev


def compare(ctx, ring, kept) -> list:
    """Each kept step's features and mask against the reference on the
    stream's samples that the step's frames cover."""
    cfg = ctx.ref_config()
    C = ring.shape[2]
    int_path = ctx.config["path"] == "int"
    worst, nonfinite, mask_off, off = 0.0, 0, 0, 0
    for k, (feats, mask) in sorted(kept.items()):
        lo, hi = frames_done(cfg, k * C), frames_done(cfg, (k + 1) * C)
        want_mask = torch.zeros_like(mask)
        want_mask[:, : hi - lo] = True
        mask_off += int((mask != want_mask).sum())
        if hi == lo:
            continue
        start = lo * cfg.hop
        seg, prev = step_audio(ring, start, (hi - 1) * cfg.hop + cfg.nfft)
        got = feats[:, : hi - lo]
        if int_path:
            want = torch_ref.mfcc_int(seg, cfg, prev=prev)
            off += int((got.to(torch.int64) != want).sum())
        else:
            e, nf = max_abs(got, torch_ref.mfcc_float(seg, cfg, prev=prev))
            worst, nonfinite = max(worst, e), nonfinite + nf
    checks = [Check("mask_off", mask_off, 0)]
    if int_path:
        return checks + [Check("elements_off", off, ctx.config["limit"])]
    return checks + [Check("max_abs_err", worst, ctx.config["limit"]),
                     Check("nonfinite_off", nonfinite, 0)]
