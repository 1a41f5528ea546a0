"""Multi-rank scaling on ``torch.distributed``: dp over streams, sp over
time.

The counterpart of ``mfcc_tpu.parallel.sharding``.  The algorithm has no
cross-stream dependence, so scaling is

  * dp -- data parallelism over the stream axis, no collectives;
  * sp -- sequence parallelism over the time axis of long signals: the
    overlapped frames cross shard boundaries.  The JAX package leaves that
    halo to XLA; here it is the explicit exchange of ``halo.py``.

Each rank holds a plain local block (``mesh.shard_streams``) and runs the
single-device port on it; the callables below take and return local blocks,
and ``mesh.gather`` assembles them (a check helper).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import MFCCConfig
from ..ops import (fladder, float_fused, float_ops, int_fused, int_ops,
                   stream_fused)
from ..pipeline import MFCC
from ..streaming import StreamingMFCC, StreamState
from . import halo
from . import mesh as meshlib
from .mesh import gather, make_mesh, shard_rows, shard_streams  # noqa: F401

USE_KERNELS = ("auto", False, "interpret")


def _tag(fn, impl: str, layout: str):
    """Expose the route a factory selected (the dryrun prints it) and the
    layout of its output blocks (for ``mesh.gather``)."""
    fn.selected_impl = impl
    fn.layout = layout
    return fn


def _kernel_route(family: bool, use_kernels, device: torch.device) -> bool:
    """The routing policy of the sharded factories.  ``use_kernels``:
    "auto" takes the kernels for CUDA tensors and a config in their
    family, the chain otherwise (as the JAX package takes its Mosaic
    kernels on a TPU only); False always takes the chain; "interpret"
    forces the kernel route through the kernels' plain versions on any
    device, the counterpart of the JAX package's interpret mode, and
    raises outside the family as JAX does."""
    if use_kernels not in USE_KERNELS:
        raise ValueError(f"use_kernels={use_kernels!r}: one of {USE_KERNELS}")
    if use_kernels == "interpret" and not family:
        raise ValueError("kernel config unsupported for interpret routing")
    if use_kernels is False:
        return False
    return use_kernels == "interpret" or (family and device.type == "cuda")


def shard_state(arrays, mesh: DeviceMesh) -> StreamState:
    """This rank's dp block of a ``StreamState`` given whole, on the
    rank's device: a mapping with the field names (a JAX-layout carry as
    numpy arrays, e.g. an ``np.load`` of a state the JAX package saved,
    which ``StreamState.from_numpy`` takes whole) or a ``StreamState``."""
    if isinstance(arrays, StreamState):
        arrays = arrays._asdict()
    return StreamState(*(shard_rows(arrays[f], mesh)
                         for f in StreamState._fields))


def _energy(cep: torch.Tensor) -> torch.Tensor:
    """The mean c0^2 over every rank's frames (JAX's psum'd
    ``mean(c0.astype(f32) ** 2)``): an all-reduce of this rank's sum (in
    float64) and count; an f32 scalar on ``cep``'s device."""
    c0 = cep[..., 0].to(torch.float32)
    local = torch.stack([(c0 * c0).sum(dtype=torch.float64),
                         torch.tensor(float(c0.numel()), dtype=torch.float64,
                                      device=cep.device)])
    dist.all_reduce(local)
    return (local[0] / local[1]).to(torch.float32)


def mfcc_sharded_fn(mesh: DeviceMesh, cfg: MFCCConfig = MFCCConfig(), *,
                    int_path: bool = False, method: str = "dft",
                    precision: str = "highest",
                    dtype: torch.dtype = torch.float32, use_kernels="auto"):
    """A callable: this rank's (S/dp, T/sp) block (``shard_streams``) ->
    (local cepstra, global energy), the energy being the mean c0^2 over the
    whole batch, all-reduced.

    Kernel route (``use_kernels="auto"`` on CUDA tensors and a config in
    the kernels' family, or ``"interpret"``): streams over ALL ranks, as the
    JAX kernel route shards over every mesh axis.  With sp > 1 the blocks
    are first regrouped by one all-to-all over sp, so that each rank holds
    S/(dp*sp) whole streams; the cepstra are (S/(dp*sp), F, ncep) blocks in
    mesh order (``layout="flat"``).  Each rank runs the single-device
    module: ``MFCC(cfg).int`` -> K2; ``MFCC(cfg)`` -> K1 at an even hop
    and K6 (K1's kernel at that hop, JAX's recompute kernel) at an odd
    one, the float family being JAX's (``float_fused.float_config_ok``).
    An even hop goes through K1 and not, as in the JAX package, through
    the split-DFT kernel at 6 passes: on the H100 K1 takes 1.13 ms against
    K5's 3.45 ms at S=1024 x 4 s and reads 3.8e-6 from the float64 oracle
    (ROADMAP A.3; H100 80GB HBM3, 700 W).  Under "interpret" the ranks run
    the plain versions of K1 / K6 and K2.

    Chain route (the CPU, ``use_kernels=False``, other configs): each rank
    runs the ``float_ops`` / ``int_ops`` chain on its streams; with sp > 1
    the frames that cross a shard boundary come through ``halo.py``'s
    explicit exchange (``halo.chain_frames``) and the cepstra are
    (S/dp, F_loc, ncep) blocks, the frames each sp shard owns
    (``layout="dp-sp"``).  The FPGA recipe only: Kaldi's and Whisper's
    raise."""
    if cfg.recipe != "fpga":
        raise ValueError(f"mfcc_sharded_fn runs the FPGA recipe, not "
                         f"{cfg.recipe!r}")
    device = meshlib.mesh_device(mesh)
    if int_path:
        family = int_fused.int_config_ok(cfg)
    else:
        family = (method == "dft" and precision == "highest"
                  and dtype == torch.float32
                  and float_fused.float_config_ok(cfg))
    sp = meshlib.axis_size(mesh, "sp")

    if _kernel_route(family, use_kernels, device):
        interpret = use_kernels == "interpret"
        fe = MFCC(cfg, device=device)     # float: K1, or K6 at an odd hop
        if int_path:
            impl = ((lambda a: int_fused.mfcc_int_fused_plain(a, cfg))
                    if interpret else fe.int)
        else:
            plain = (fladder.mfcc_float_ladder_plain if cfg.hop % 2 == 0
                     else float_fused.mfcc_recomp_t_plain)
            impl = (lambda a: plain(a, cfg)) if interpret else fe
        group = mesh.get_group("sp") if sp > 1 else None

        def fn(audio):
            x = meshlib.local_block(audio, mesh)
            if sp > 1:        # (S/dp, T/sp) -> (S/(dp*sp), T): one all-to-all
                S_l, T_l = x.shape
                if S_l % sp:
                    raise ValueError(f"{S_l} streams a dp block do not split "
                                     f"over sp={sp}")
                parts = x.reshape(sp, S_l // sp, T_l).contiguous()
                got = torch.empty_like(parts)    # block k from sp rank k
                dist.all_to_all_single(got, parts, group=group)
                x = got.permute(1, 0, 2).reshape(S_l // sp, sp * T_l)
            cep = impl(x.contiguous())
            return cep, _energy(cep)

        return _tag(fn, "kernel/all-ranks" + ("(interpret)" if interpret
                                              else ""), "flat")

    def fn(audio):
        if sp == 1:
            x = meshlib.local_block(audio, mesh)
            if int_path:
                cep = int_ops.mfcc_int_batch(x, cfg)
            else:
                cep = float_ops.mfcc_batch(x, cfg, method=method,
                                           precision=precision, dtype=dtype)
        else:
            frames = halo.chain_frames(audio, mesh, cfg, int_path=int_path,
                                       dtype=dtype)
            if int_path:
                cep = int_ops.mfcc_int_frames(frames, cfg)
            else:
                cep = float_ops.mfcc_frames(frames, cfg, method=method,
                                            precision=precision, dtype=dtype)
        return cep, _energy(cep)

    return _tag(fn, "chain/dp-sp" + ("+halo" if sp > 1 else ""), "dp-sp")


def streaming_sharded_fn(mesh: DeviceMesh, cfg: MFCCConfig = MFCCConfig(), *,
                         int_path: bool = False,
                         dtype: torch.dtype = torch.float32,
                         use_kernels="auto"):
    """Sharded streaming step: state and chunks sharded over dp (the rank's
    block of streams; ranks along sp hold the same block, as a JAX
    ``P("dp", None)`` array is replicated over sp).  Streams are
    independent, so the state never crosses ranks: no collective.

    ``step(chunks, state, reset=None, lengths=None)`` on this rank's
    (S/dp, C) chunks, ``StreamState`` block (``shard_state``) and (S/dp,)
    flags -> (feats, mask, new state), as ``StreamingMFCC.step``.  Kernel
    route ("auto" on CUDA tensors and a config in K4's family): each rank
    runs its streams' ``StreamingMFCC`` step, one K4 launch a full-chunk
    step; under "interpret" the step-level plain versions
    (``stream_fused.stream_step_*_state_plain``).  Flush steps (``lengths``
    given) and the chain route take the chain step, as in the JAX
    package."""
    device = meshlib.mesh_device(mesh)
    sm = StreamingMFCC(cfg, int_path=int_path, dtype=dtype, device=device)
    family = sm._route == "fused"
    kernels = _kernel_route(family, use_kernels, device)
    interpret = use_kernels == "interpret"
    plain = (stream_fused.stream_step_int_state_plain if int_path
             else stream_fused.stream_step_float_state_plain)

    def step(chunks, state: StreamState, reset=None, lengths=None):
        if kernels and not interpret and lengths is None:
            return sm.step(chunks, state, reset)       # one K4 launch
        chunks = sm._as_tensor(chunks)
        reset = (torch.zeros((chunks.shape[0],), dtype=torch.bool,
                             device=device) if reset is None
                 else sm._as_tensor(reset, torch.bool))
        if kernels and lengths is None:                # "interpret"
            if chunks.dtype != torch.int16:
                chunks = chunks.to(sm.dtype)
            out = plain(state.buffer, chunks, state.count, state.prev, reset,
                        cfg)
            return out[0], out[1], StreamState(*out[2:])
        if lengths is not None:
            lengths = sm._as_tensor(lengths, torch.int32)
        return sm._chain_step(chunks.to(sm.dtype), state, reset, lengths)

    impl = ("fused-stream-kernel/dp" + ("(interpret)" if interpret else "")
            if kernels else "chain-step/dp")
    return _tag(step, impl, "dp")
