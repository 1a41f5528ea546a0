"""The controls of ``correct``: the plain reference put in the program's
place, computed one precision below what the configuration states
(``ref/torch_ref.py``: TF32 operands in float32 for the float deployment, a
float32 filterbank for the INT one), at the cell's own sizes and on the
cell's own inputs, and judged by the cell's own comparison.  Each control
has to come out as not correct:

    python3 -m perfbench.control --workload float.batch --seeds 1,2,3

The serving cell's control is judged on the frames that its sampled clients
would have received over a window of ``--seconds``; the streaming cell's on
its kept steps and on the last two steps of a window of ``--steps``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import harness, inputs
from .drivers import batch, serve, stream
from .drivers.clients import chunk_frames
from .ref import torch_ref
from .ref.config import MAGIC_WORD


def _ref(ctx, x, prev=None):
    cfg = ctx.ref_config()
    if ctx.config["path"] == "int":
        return torch_ref.mfcc_int(x, cfg, prev=prev, control=True)
    return torch_ref.mfcc_float(x, cfg, prev=prev, control=True)


def batch_control(ctx) -> list:
    audio = batch.make_inputs(ctx)
    return batch.compare(ctx, audio, [_ref(ctx, x) for x in audio])


def stream_control(ctx, steps: int) -> list:
    cfg = ctx.ref_config()
    ring = stream.make_ring(ctx)
    S, C = ring.shape[1], ring.shape[2]
    slots = (cfg.windowlen - 1 + C - cfg.nfft) // cfg.hop + 1
    kept = {}
    for k in sorted(stream.keep_steps(ctx) | {steps - 2, steps - 1}):
        lo = stream.frames_done(cfg, k * C)
        hi = stream.frames_done(cfg, (k + 1) * C)
        feats = torch.zeros((S, slots, cfg.nceptrums), device=ctx.device)
        mask = torch.zeros((S, slots), dtype=torch.bool, device=ctx.device)
        mask[:, : hi - lo] = True
        if hi > lo:
            seg, prev = stream.step_audio(ring, lo * cfg.hop,
                                          (hi - 1) * cfg.hop + cfg.nfft)
            feats[:, : hi - lo] = _ref(ctx, seg, prev).to(feats.dtype)
        kept[k] = (feats, mask)
    return stream.compare(ctx, ring, kept)


def serve_control(ctx) -> list:
    cfg = ctx.ref_config()
    p = ctx.traffic
    C, R, N = p["chunk"], p["ring_chunks"], p["clients"]
    sent = int(np.ceil((p["warm_s"] + ctx.seconds) * cfg.samplerate / C))
    ids = serve.sample_clients(ctx.seed, N, p["sample_clients"])
    blobs = []
    for c in ids:
        ring = inputs.client_audio(ctx.seed, c, R * C)
        audio = np.tile(ring, -(-sent // R))[: sent * C]
        cep = _ref(ctx, torch.as_tensor(audio[None], device=ctx.device))[0]
        cep = torch.clamp(cep, -32768, 32767).cpu().numpy().astype(">i2")
        n = int(chunk_frames(sent - 1, C, cfg.windowlen, cfg.hop))
        frames = np.empty((n, cfg.nceptrums + 1), ">u2")
        frames[:, 0] = MAGIC_WORD
        frames[:, 1:] = cep[:n].view(">u2")
        blobs.append(np.frombuffer(frames.tobytes(), np.uint8))
    res = {"sample": np.asarray(ids), "sent_n": np.full(N, sent),
           "kept": np.concatenate(blobs),
           "kept_len": np.asarray([len(b) for b in blobs])}
    return serve.compare(ctx, res, 0)


def readings(bench: dict, workload: str, seed: int, seconds: float,
             steps: int, device, traffic_overrides: dict | None = None
             ) -> list:
    cell, conf = harness.find_cell(bench, workload)
    traffic = harness.read_json(harness.traffic_path(cell["traffic"]))
    traffic.update(traffic_overrides or {})
    ctx = harness.Context(workload, harness.read_json(harness.ROOT
                                                      / conf["file"]),
                          traffic, seed, seconds, False, device, 0.0)
    kind = traffic["driver"]
    if kind == "batch":
        return batch_control(ctx)
    if kind == "stream":
        return stream_control(ctx, steps)
    return serve_control(ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--steps", type=int, default=100_000)
    args = ap.parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    bench = harness.load_benchmark()
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        checks = readings(bench, args.workload, seed, args.seconds,
                          args.steps, device)
        failed = not all(c.ok for c in checks)
        failed_all &= failed
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": not failed,
                          "checks": {c.name: c.value for c in checks}}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
