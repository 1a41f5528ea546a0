"""Explicit sequence-parallel halo exchange over the sp axis.

The counterpart of ``mfcc_tpu.parallel.halo``.  Each time-shard sends its
LEADING ``nfft - hop`` emphasized samples to its left neighbour on the sp
axis (``shift``: one ``batch_isend_irecv`` on the sp group, the
``ppermute`` of the JAX package), and every frame is then computed
shard-locally.  Pre-emphasis also crosses each boundary, by one sample: each
shard first sends its last raw sample to its right neighbour, which passes
it to ``framing.preemphasis`` (``preemphasis_int``) as the carry.  Float
emphasis is f32, rounded twice; INT emphasis takes int32 samples as they
are (no mod 2^16 wire rule), as the JAX halo and K3-v1 do.

Under gloo an exchange of CUDA tensors goes through pinned host buffers:
gloo's send and receive read and write host memory (a device pointer
fails, "writev: Bad address", on torch 2.11).  Under NCCL, and for CPU
tensors, nothing is staged.

Frames: float through the ``float_ops`` chain at the given precision (as
the JAX halo runs ``float_ops.mfcc_frames``), INT through
``MFCC.int_frames`` (K3 on the card).

Constraints (checked): the per-shard length must be a multiple of hop (so
frame starts align with shard boundaries) and at least nfft.  Use
``pad_for_halo`` to round a signal up.

``chain_frames`` is the same exchange for any per-shard length (a halo of
windowlen - 1 samples): the frames a rank owns in the sharded chain route
of ``sharding.mfcc_sharded_fn``, where the JAX package leaves the halo to
XLA.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import MFCCConfig
from ..ops import float_ops, framing
from ..pipeline import MFCC
from . import mesh as meshlib


def pad_for_halo(T: int, mesh: DeviceMesh, cfg: MFCCConfig) -> int:
    """Smallest T' >= T with T' divisible by sp*hop and T'/sp >= nfft."""
    sp = meshlib.axis_size(mesh, "sp")
    step = sp * cfg.hop
    Tp = -(-T // step) * step
    return max(Tp, sp * -(-cfg.nfft // cfg.hop) * cfg.hop)


def staged(t: torch.Tensor) -> bool:
    """Whether an exchange of ``t`` goes through host memory: a CUDA tensor
    under gloo."""
    return t.device.type == "cuda" and dist.get_backend() == "gloo"


def shift(t: torch.Tensor, mesh: DeviceMesh, step: int
          ) -> torch.Tensor | None:
    """Send ``t`` to the neighbour ``step`` (+1 or -1) along sp and return
    what the neighbour on the other side sent (the same shape and dtype,
    on ``t``'s device), or None where there is none: the edge shards,
    which JAX's ``ppermute`` fills with zeros.  One ``batch_isend_irecv``
    on the sp group, through pinned host buffers where ``staged``."""
    n, i = meshlib.axis_size(mesh, "sp"), meshlib.axis_index(mesh, "sp")
    if n == 1:
        return None
    group = mesh.get_group("sp")
    buf = t.contiguous()
    if staged(buf):
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        buf = host.copy_(buf)
    recv = None
    ops = []
    if 0 <= i + step < n:
        ops.append(dist.P2POp(dist.isend, buf,
                              dist.get_global_rank(group, i + step), group))
    if 0 <= i - step < n:
        recv = torch.empty_like(buf)
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, i - step), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return None if recv is None else recv.to(t.device)


def emphasize(audio: torch.Tensor, mesh: DeviceMesh, cfg: MFCCConfig,
              int_path: bool, dtype: torch.dtype) -> torch.Tensor:
    """Pre-emphasis of this rank's (S_loc, T_loc) time block, carried over
    the sp boundary on its left (the left neighbour's last raw sample;
    none on the first shard)."""
    if int_path:
        x = audio.to(torch.int32)
        carry = shift(x[:, -1].contiguous(), mesh, +1)
        return framing.preemphasis_int(x, carry, width=cfg.width)
    x = audio.to(dtype)
    return framing.preemphasis(x, shift(x[:, -1].contiguous(), mesh,
                                                 +1))


def _extend(emph: torch.Tensor, mesh: DeviceMesh, n: int) -> torch.Tensor:
    """``emph`` followed by the right neighbour's leading ``n`` emphasized
    samples (zeros on the last shard)."""
    halo = shift(emph[:, :n].contiguous(), mesh, -1)
    if halo is None:
        halo = emph.new_zeros((emph.shape[0], n))
    return torch.cat([emph, halo], dim=-1)


def chain_frames(audio, mesh: DeviceMesh, cfg: MFCCConfig, *,
                 int_path: bool, dtype: torch.dtype) -> torch.Tensor:
    """The frames this rank owns of an (S, T) batch cut (dp, sp), T = sp *
    T_loc: those whose first sample lies in its time block and whose
    window ends by T, as (S_loc, F_loc, nfft) emphasized frames (F_loc may
    be 0; the blocks' F_loc add up to ``cfg.n_frames(T)`` along sp).  One
    carry exchange and one halo exchange of windowlen - 1 samples, which
    needs T_loc >= windowlen - 1."""
    x = meshlib.local_block(audio, mesh)
    sp, j = meshlib.axis_size(mesh, "sp"), meshlib.axis_index(mesh, "sp")
    S_loc, L = x.shape
    T, hop, wl = sp * L, cfg.hop, cfg.windowlen
    if sp > 1 and L < wl - 1:
        raise ValueError(f"per-shard length {L} < windowlen - 1 = {wl - 1}: "
                         "a frame would span more than two shards")
    emph = emphasize(x, mesh, cfg, int_path, dtype)
    if sp > 1:
        emph = _extend(emph, mesh, wl - 1)
    first = -(-j * L // hop)                       # first frame starting here
    end = min(-(-(j + 1) * L // hop), cfg.n_frames(T))
    F_loc = max(0, end - first)
    if F_loc == 0:
        return emph.new_zeros((S_loc, 0, cfg.nfft))
    off = first * hop - j * L
    seg = emph[:, off: off + (F_loc - 1) * hop + wl]
    return framing.extract_frames(seg, cfg.nfft, hop, windowlen=wl)


def halo_frames(audio, mesh: DeviceMesh, cfg: MFCCConfig, *,
                int_path: bool, dtype: torch.dtype) -> torch.Tensor:
    """This rank's (S_loc, T_loc/hop, nfft) emphasized frames under the
    halo schedule: frame starts 0, hop, ..., T_loc - hop of its block, the
    last ones reaching into the right neighbour's leading nfft - hop
    samples (zeros past the last shard)."""
    x = meshlib.local_block(audio, mesh)
    T_loc, nfft, hop = x.shape[-1], cfg.nfft, cfg.hop
    if T_loc % hop or T_loc < nfft:
        raise ValueError(
            f"per-shard length {T_loc} must be a multiple of hop {hop} "
            f"and >= nfft {nfft}: pad the signal with pad_for_halo")
    ext = _extend(emphasize(x, mesh, cfg, int_path, dtype), mesh, nfft - hop)
    frames = framing.extract_frames(ext, nfft, hop, windowlen=cfg.windowlen)
    return frames[:, : T_loc // hop].contiguous()


def mfcc_halo_fn(mesh: DeviceMesh, cfg: MFCCConfig = MFCCConfig(), *,
                 int_path: bool = False, method: str = "dft",
                 precision: str = "highest",
                 dtype: torch.dtype = torch.float32):
    """A callable: this rank's (S_loc, T_loc) block -> (S_loc, T_loc/hop,
    ncep) cepstra, with an explicit halo over sp.  The blocks gathered
    ``"dp-sp"`` (``mesh.gather``) are (S, F_padded, ncep), F_padded =
    T/hop; rows beyond cfg.n_frames(T) are padding (their windows extend
    past T): slice them off with ``[:, :cfg.n_frames(T)]``.

    ``int_path=True`` runs the bit-exact fixed-point pipeline under the
    same halo schedule (the exchange carries emphasized int32 samples).
    The FPGA recipe only: Kaldi's and Whisper's raise."""
    if cfg.recipe != "fpga":
        raise ValueError(f"mfcc_halo_fn runs the FPGA recipe, not "
                         f"{cfg.recipe!r}")
    if int_path:
        features = MFCC(cfg, device=meshlib.mesh_device(mesh)).int_frames
    else:
        def features(frames):
            return float_ops.mfcc_frames(frames, cfg, method=method,
                                         precision=precision, dtype=dtype)

    def fn(audio):
        return features(halo_frames(audio, mesh, cfg, int_path=int_path,
                                    dtype=dtype))

    fn.selected_impl = ("halo/" + ("int-frames" if int_path
                                   else f"chain-{precision}"))
    return fn
