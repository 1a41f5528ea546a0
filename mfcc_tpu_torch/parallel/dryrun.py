"""One sharded step of every parallel path on an N-rank group.

The counterpart of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py``): ``dryrun_multichip(n)`` starts ``n`` ranks with
``bootstrap.run_in_group`` and runs on them the sharded batch (the chain
route), a float and an INT streaming step, the float and INT halo, and the
kernel route against the chain, then prints one ``dryrun_multichip OK:``
line and returns it.

    python3 -m mfcc_tpu_torch.parallel.dryrun N [cpu|cuda]

On the card (the default) the kernel route runs the kernels; on the CPU
(``device_type="cpu"``) it runs their plain versions ("interpret").
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import MFCCConfig
from ..streaming import init_state
from . import bootstrap
from .halo import mfcc_halo_fn, pad_for_halo
from .mesh import axis_size, gather, make_mesh, shard_rows, shard_streams
from .sharding import mfcc_sharded_fn, shard_state, streaming_sharded_fn


def _check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip check failed: {what}")


def _dryrun_rank(device_type: str) -> str:
    cfg = MFCCConfig(nfft=512)
    mesh = make_mesh(device_type=device_type)
    dp, sp = axis_size(mesh, "dp"), axis_size(mesh, "sp")
    on_card = mesh.device_type == "cuda"

    # batch path: (S, T) cut dp x sp; frames cross the sp shards
    S = max(2 * dp, 4) * sp
    T = 512 + 170 * (2 * sp + 1)          # a few frames per sp shard
    audio = np.random.default_rng(1).integers(-3000, 3000, (S, T)).astype(
        np.float32)
    x = shard_streams(audio, mesh)
    fn = mfcc_sharded_fn(mesh, cfg, use_kernels=False)
    cep, energy = fn(x)
    cep = gather(cep, mesh, fn.layout)
    _check(cep.shape == (S, cfg.n_frames(T), cfg.nceptrums), cep.shape)
    _check(bool(torch.isfinite(energy)), float(energy))

    # streaming: state over dp, one full-chunk step, float and bit-exact INT
    reset = shard_rows(np.zeros(S, bool), mesh)
    step = streaming_sharded_fn(mesh, cfg)
    state = shard_state(init_state(S, cfg, device=mesh.device_type), mesh)
    feats, mask, state = step(shard_rows(audio[:, :680], mesh), state, reset)
    _check(feats.shape[0] == S // dp
           and bool(torch.isfinite(feats[mask]).all()), feats.shape)
    istep = streaming_sharded_fn(mesh, cfg, int_path=True)
    istate = shard_state(init_state(S, cfg, torch.int32,
                                    device=mesh.device_type), mesh)
    ifeats, _, istate = istep(shard_rows(audio[:, :680].astype(np.int32),
                                         mesh), istate, reset)
    _check(ifeats.dtype == torch.int32 and ifeats.shape[0] == S // dp,
           ifeats.shape)

    # the explicit sp halo, float and bit-exact INT
    Tp = pad_for_halo(T, mesh, cfg)
    hx = np.pad(audio, ((0, 0), (0, Tp - T)))
    hout = gather(mfcc_halo_fn(mesh, cfg)(shard_streams(hx, mesh)), mesh)
    _check(hout.shape == (S, Tp // cfg.hop, cfg.nceptrums), hout.shape)
    ihout = gather(mfcc_halo_fn(mesh, cfg, int_path=True)(
        shard_streams(hx.astype(np.int32), mesh)), mesh)
    _check(ihout.shape == hout.shape and ihout.dtype == torch.int32,
           ihout.shape)

    # the kernel route against the chain: the kernels on the card, their
    # plain versions on the CPU
    kfn = mfcc_sharded_fn(mesh, cfg,
                          use_kernels="auto" if on_card else "interpret")
    kcep = gather(kfn(x)[0], mesh, kfn.layout)
    _check(kcep.shape == cep.shape, kcep.shape)
    err = float((kcep - cep).abs().max())
    _check(err < 1e-3, err)               # float64 inside vs the f32 chain

    return (f"dryrun_multichip OK: mesh={dict(dp=dp, sp=sp)} "
            f"device={x.device.type} backend="
            f"{torch.distributed.get_backend()} cep={tuple(cep.shape)} "
            f"streaming feats={tuple(feats.shape)} int={tuple(ifeats.shape)}"
            f" halo={tuple(hout.shape)} int_halo={tuple(ihout.shape)}; "
            f"selected impls: batch={fn.selected_impl} kernel-routed="
            f"{kfn.selected_impl} (max-abs vs chain {err:.3e}) streaming="
            f"{step.selected_impl} int-streaming={istep.selected_impl}")


def dryrun_multichip(n_devices: int, *, device_type: str = "cuda",
                     timeout: float = 120.0) -> str:
    """Run every sharded path once on ``n_devices`` ranks and print the
    ``dryrun_multichip OK:`` line (rank 0's); raise if a rank fails.  The
    backend is ``bootstrap.default_backend``'s: NCCL where each rank has a
    card of its own, else gloo (the CPU, or ranks that share a card)."""
    line = bootstrap.run_in_group(_dryrun_rank, n_devices,
                                  args=(device_type,),
                                  device_type=device_type,
                                  timeout=timeout)[0]
    print(line, flush=True)
    return line


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]),
                     device_type=sys.argv[2] if len(sys.argv) > 2 else "cuda")
