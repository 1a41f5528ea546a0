"""Start the ranks of one ``torch.distributed`` group.

The counterpart of ``mfcc_tpu.parallel.bootstrap``.  The JAX package
re-execs a child process with a forced N-device XLA CPU platform, so that
one process sees an N-device mesh.  Under ``torch.distributed`` every rank
is a process of its own: ``run_in_group`` spawns N processes (start method
``spawn``), each joins the group through a ``FileStore`` in a fresh
temporary directory (never a fixed port: several test workers may start
groups at once), runs the target, and hands back what it returned.

Ranks run on the card unless the caller asks for the CPU
(``device_type="cpu"``): a CUDA rank runs on ``cuda:<rank % device_count>``
and raises on a host without a card.  Backends (``default_backend``):
``nccl`` with one rank a card; ``gloo`` on the CPU and for ranks that share
a card (NCCL refuses two ranks on one device).

``init_process_group(timeout=...)`` bounds every collective, and the join
has a wall-clock deadline, so a rank that dies fails the run instead of
hanging its peers.  A rank that fails raises in the caller, naming the
rank, its traceback and the end of its stderr.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

import torch

STORE_ENV = "MFCC_TORCH_STORE"   # the FileStore path, beside torchrun's names
STDERR_TAIL = 4000               # bytes of a failed rank's stderr in the error


def group_env(rank: int, world_size: int, store_path: str) -> dict:
    """The environment of rank ``rank`` of a one-host group of
    ``world_size`` ranks: torchrun's ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, and the ``FileStore`` path
    under ``STORE_ENV``."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world_size),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world_size),
            STORE_ENV: store_path}


def rank_device(rank: int, device_type: str, backend: str,
                world_size: int) -> torch.device:
    """The device of a rank: the CPU, or ``cuda:<rank % device_count>``
    (raises without a card, and for NCCL with fewer cards than ranks)."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device_type {device_type!r}: 'cpu' or 'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA rank needs a card and this host has none "
            "(torch.cuda.is_available() is false): pass device_type=\"cpu\"")
    n = torch.cuda.device_count()
    if backend == "nccl" and world_size > n:
        raise RuntimeError(
            f"NCCL runs one rank a card: {world_size} ranks, {n} card(s); "
            "ranks that share a card take backend=\"gloo\"")
    return torch.device("cuda", rank % n)


def default_backend(device_type: str, world_size: int) -> str:
    """NCCL where each rank has a card of its own, else gloo (the CPU, or
    ranks that share a card)."""
    if (device_type == "cuda" and torch.cuda.is_available()
            and world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def init_group(rank: int, world_size: int, store_path: str, *,
               backend: str | None = None, device_type: str = "cuda",
               timeout: float = 60.0) -> torch.device:
    """Join the group as ``rank`` through a ``FileStore`` at
    ``store_path`` and return the rank's device (made the current CUDA
    device for a CUDA rank; raises on a host without a card: pass
    ``device_type="cpu"`` for a host rank).  ``backend`` defaults to
    ``default_backend``.  ``timeout`` bounds the rendezvous and every
    collective.  The caller ends the group with
    ``torch.distributed.destroy_process_group()``."""
    import torch.distributed as dist
    backend = backend or default_backend(device_type, world_size)
    device = rank_device(rank, device_type, backend, world_size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()     # so that DeviceMesh keeps this device
    delta = datetime.timedelta(seconds=timeout)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=delta)
    return device


def _rank_main(rank, target, args, world_size, store_path, backend,
               device_type, timeout, outdir):
    """One rank: stderr to a file, join the group, run the target, store
    its result for the caller."""
    import torch.distributed as dist
    err = os.open(os.path.join(outdir, f"stderr.{rank}"),
                  os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(err, 2)
    os.close(err)
    os.environ.update(group_env(rank, world_size, store_path))
    if device_type == "cpu":      # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    init_group(rank, world_size, store_path, backend=backend,
               device_type=device_type, timeout=timeout)
    try:
        result = target(*args)
        dist.barrier()
    except BaseException:
        traceback.print_exc()     # into this rank's stderr file as well
        raise
    finally:
        dist.destroy_process_group()
    with open(os.path.join(outdir, f"result.{rank}"), "wb") as f:
        pickle.dump(result, f)


def _tail(path: str) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - STDERR_TAIL))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def _failure(ctx, outdir: str, world_size: int, what: str) -> str:
    """The report of a failed group: every rank that did not exit 0 (the
    first to fail, and the peers it took down), with its stderr's end."""
    lines = [f"a group of {world_size} ranks ({what}) failed"]
    for rank, proc in enumerate(ctx.processes):
        proc.join()
        if proc.exitcode:
            lines.append(f"-- rank {rank} of {world_size}: exit code "
                         f"{proc.exitcode}; its stderr ends:\n"
                         + _tail(os.path.join(outdir, f"stderr.{rank}")))
    return "\n".join(lines)


def run_in_group(target, world_size: int, *, args: tuple = (),
                 backend: str | None = None, device_type: str = "cuda",
                 timeout: float = 60.0) -> list:
    """Run ``target(*args)`` on each of ``world_size`` ranks of one group
    and return the ranks' results, in rank order.

    The ranks run on the card (``device_type="cuda"``; this raises at once
    on a host without one) unless the caller passes ``device_type="cpu"``;
    ``backend`` defaults to ``default_backend``.  The target builds its
    mesh with the same device type (``make_mesh(device_type=...)``).

    ``target`` must be importable by name (a module-level function: spawn
    pickles it by reference), and its result picklable; return CPU tensors
    or numpy arrays.  ``timeout`` (seconds) bounds the rendezvous, each
    collective and the whole run: past it the ranks are killed and
    ``TimeoutError`` is raised.  A rank that raises or dies ends the others
    and makes this raise ``RuntimeError`` naming every rank that did not
    exit 0, each with its exit code and the end of its stderr (where a
    rank's traceback goes); the end of each rank's stderr is also copied
    to this process's stderr when the group ends."""
    import torch.multiprocessing as mp
    backend = backend or default_backend(device_type, world_size)
    rank_device(0, device_type, backend, world_size)   # fail here, not there
    outdir = tempfile.mkdtemp(prefix="mfcc_group_")
    store_path = os.path.join(outdir, "store")
    ctx = mp.start_processes(
        _rank_main, args=(target, args, world_size, store_path, backend,
                          device_type, timeout, outdir),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic()),
                               grace_period=5.0):
                if time.monotonic() >= deadline:
                    for p in ctx.processes:
                        if p.is_alive():
                            p.kill()
                        p.join()
                    raise TimeoutError(
                        f"group of {world_size} ranks ({backend}, "
                        f"{device_type}) still running after {timeout} s; "
                        "rank 0's stderr ends:\n"
                        + _tail(os.path.join(outdir, "stderr.0")))
        except (mp.ProcessRaisedException, mp.ProcessExitedException):
            raise RuntimeError(_failure(ctx, outdir, world_size,
                                        f"{backend}, {device_type}")) from None
        finally:
            for rank in range(world_size):
                sys.stderr.write(_tail(os.path.join(outdir,
                                                    f"stderr.{rank}")))
            sys.stderr.flush()
        results = []
        for rank in range(world_size):
            with open(os.path.join(outdir, f"result.{rank}"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
