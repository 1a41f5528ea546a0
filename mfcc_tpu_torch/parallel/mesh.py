"""The device mesh over a ``torch.distributed`` group, and the collectives
the sharded paths use.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the whole
initialized world, with named axes: ``dp`` over streams, ``sp`` over time.
Data stays in plain local tensors (one block a rank), not DTensors: the
kernels take plain tensors through ``ctypes``.  ``shard_streams`` cuts a
rank's block out of an (S, T) batch; ``gather`` puts blocks back together.

The collectives of the sharded paths (all-reduce, all-gather, all-to-all)
take CUDA tensors under NCCL and under gloo alike (torch 2.11); gloo's
point-to-point send and receive do not, and ``halo.shift`` stages them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("dp", "sp")


def mesh_shape(n: int, axes=AXES, shape: tuple[int, ...] | None = None
               ) -> tuple[int, ...]:
    """The mesh's shape over ``n`` ranks: ``shape`` if given (it must use
    all ``n``), else (n,) for one axis and, for two, (n//2, 2) for even
    n > 1 and (n, 1) otherwise -- dp (independent streams) takes the large
    factor, sp (time) a small one, since only the frame halo crosses sp."""
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        else:
            sp = 2 if n % 2 == 0 and n > 1 else 1
            shape = (n // sp, sp)
    shape = tuple(int(d) for d in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not use all {n} ranks")
    return shape


def make_mesh(n_devices: int | None = None, axes=AXES,
              shape: tuple[int, ...] | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """A mesh over the initialized world (``n_devices`` defaults to the
    world size and must equal it), factored by ``mesh_shape``.
    ``device_type`` is where this rank's blocks live: ``None`` is the card
    ("cuda", the current CUDA device), and raises on a host without one;
    pass ``"cpu"`` for ranks on the host (as their group's
    ``bootstrap.run_in_group(device_type="cpu")``)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed group: start "
            "the ranks with mfcc_tpu_torch.parallel.bootstrap.run_in_group "
            "(or join one with bootstrap.init_group)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(
            f"requested a {n}-device mesh but the group has {world} rank(s) "
            f"({dist.get_backend()}); a mesh spans the whole group: start "
            f"{n} ranks with mfcc_tpu_torch.parallel.bootstrap.run_in_group")
    shape = mesh_shape(n, tuple(axes), shape)
    device_type = device_type or "cuda"
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device_type {device_type!r}: 'cpu' or 'cuda'")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh() lays the mesh on the CUDA card by default and this "
            "host has none (torch.cuda.is_available() is false): pass "
            "device_type=\"cpu\" for ranks on the host")
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axes))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of axis ``name`` (1 for an axis the mesh lacks)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(name, 1)


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate on axis ``name`` (0 for an axis the mesh
    lacks)."""
    if name not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(name)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: the current CUDA device of a CUDA mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _block(x, axis: int, n: int, i: int, what: str):
    size = x.shape[axis]
    if size % n:
        raise ValueError(f"{what}: axis {axis} of length {size} does not "
                         f"split into {n} equal blocks")
    b = size // n
    return x[(slice(None),) * axis + (slice(i * b, (i + 1) * b),)]


def _on(x, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.ascontiguousarray(x))     # a copy
    return x.to(device).contiguous()


def shard_streams(audio, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's (S/dp, T/sp) block of an (S, T) batch (numpy or a
    tensor on any device), as a plain tensor on the rank's device.  S and
    T must split evenly."""
    x = _block(audio, 0, axis_size(mesh, "dp"), axis_index(mesh, "dp"),
               "streams")
    x = _block(x, x.ndim - 1, axis_size(mesh, "sp"), axis_index(mesh, "sp"),
               "time")
    return _on(x, mesh_device(mesh))


def local_block(audio, mesh: DeviceMesh) -> torch.Tensor:
    """A rank's (S_loc, T_loc) block as the sharded callables take it: a
    tensor on the rank's device (a numpy array is put there)."""
    device = mesh_device(mesh)
    if isinstance(audio, torch.Tensor):
        if audio.device != device:
            raise ValueError(f"block is on {audio.device} but this rank "
                             f"runs on {device}: shard it with shard_streams")
    else:
        audio = torch.as_tensor(np.asarray(audio), device=device)
    if audio.ndim != 2:
        raise ValueError(f"a rank's block is (S_loc, T_loc), got "
                         f"{tuple(audio.shape)}")
    return audio


def shard_rows(x, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's dp block of the leading (stream) axis of ``x``, on the
    rank's device: chunks (S, C), flags (S,), state fields."""
    return _on(_block(x, 0, axis_size(mesh, "dp"), axis_index(mesh, "dp"),
                      "streams"), mesh_device(mesh))


# -- collectives ----------------------------------------------------------------

def _all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in rank order."""
    outs = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, t.contiguous())
    return outs


def gather(local: torch.Tensor, mesh: DeviceMesh, layout: str = "dp-sp"
           ) -> torch.Tensor:
    """The global tensor from every rank's block, on every rank (a check
    helper: each rank receives all of it).

    ``layout="dp-sp"``: axis 0 is cut over dp and axis 1 over sp
    (``shard_streams``' layout; the chain's and the halo's cepstra);
    ``"dp"``: axis 0 is cut over dp and the ranks along sp hold the same
    block (``shard_rows``' layout; the streaming step's outputs);
    ``"flat"``: axis 0 is cut over every rank in mesh order (the kernel
    route's cepstra).  Blocks may differ in length along the cut axes."""
    if layout not in ("dp-sp", "dp", "flat"):
        raise ValueError(f"layout {layout!r}: 'dp-sp', 'dp' or 'flat'")
    dtype = local.dtype
    x = local.to(torch.uint8) if dtype == torch.bool else local
    head = torch.tensor([axis_index(mesh, "dp"), axis_index(mesh, "sp"),
                         *x.shape], dtype=torch.int64, device=x.device)
    heads = [h.tolist() for h in _all_gather(head)]
    big = [max(h[2 + a] for h in heads) for a in range(x.ndim)]
    padded = x.new_zeros(big)
    padded[tuple(slice(0, s) for s in x.shape)] = x
    blocks = _all_gather(padded)
    at = {(h[0], h[1]): b[tuple(slice(0, s) for s in h[2:])]
          for b, h in zip(blocks, heads)}
    dp, sp = axis_size(mesh, "dp"), axis_size(mesh, "sp")
    if layout == "flat":
        rows = [at[d, s] for d in range(dp) for s in range(sp)]
    elif layout == "dp" or sp == 1:
        rows = [at[d, 0] for d in range(dp)]
    else:
        rows = [torch.cat([at[d, s] for s in range(sp)], dim=1)
                for d in range(dp)]
    return torch.cat(rows).to(dtype)
