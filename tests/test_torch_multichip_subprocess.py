"""The torch package's ``parallel/`` on 2 and 4 gloo ranks on the CPU,
started by ``bootstrap.run_in_group(device_type="cpu")``: twins of
tests/test_sharding.py's twelve tests, the kernel route at an odd hop (K6's
plain version), ``dryrun_multichip(4)``, and a rank that fails or dies.

Each twin runs on every rank of one group (a group per world size, one
spawn, the ranks' default mesh: (1, 2) at 2 ranks, (2, 2) at 4); a rank
does its collectives first and its checks after, and hands its gathered
outputs back, which the test then holds against the JAX package's sharded
functions on a 1-device mesh and the oracles.  Tests that probe XLA's
device count become world-size checks; the TPU-only kernel routing test
becomes the routing test of a CPU rank (the card's is in
tests/test_torch_cuda.py).

Tolerances: INT element-exact; the dp routes (the kernel route's plain
versions, streaming) equal the unsharded port; the float sp halo equals
the chain on the same frame rows, and the sp routes in float are within
HALO_TOL = 5e-5 of the unsharded chain on the CPU (the same f32 products
summed in row blocks of another size); float within TOL_JAX = 1e-4 of JAX
and GATE = 5e-4 of the float64 oracle.  Every group has its own 60 s timeout.

JAX is imported by the tests alone (``_jax``), never at the top: the
ranks import this module to find their target.
"""

import traceback

import numpy as np
import pytest
import torch

from mfcc_tpu_torch import MFCC, MFCCConfig, StreamingMFCC
from mfcc_tpu_torch import streaming
from mfcc_tpu_torch.ops import float_ops, framing
from mfcc_tpu_torch.parallel import (bootstrap, gather, make_mesh,
                                     mfcc_halo_fn, mfcc_sharded_fn,
                                     pad_for_halo, shard_rows, shard_state,
                                     shard_streams, streaming_sharded_fn)
from mfcc_tpu_torch.parallel import dryrun, halo, mesh as meshlib
from mfcc_tpu_torch.ref import float_ref, int_ref

CFG = MFCCConfig()
TOL_JAX = 1e-4
GATE = 5e-4
HALO_TOL = 5e-5
TIMEOUT = 60.0


# -- what each rank runs ---------------------------------------------------------

def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _device_count_contract(n, mesh, sig):
    import torch.distributed as dist
    _check(dist.get_world_size() == n and mesh.size() == n,
           f"world {dist.get_world_size()}, mesh {mesh.size()}, want {n}")
    _check(meshlib.mesh_device(mesh) == torch.device("cpu"), "device")
    return {"shape": tuple(mesh.shape)}


def _oversubscription(n, mesh, sig):
    for args, kw, match in (((n + 1,), {}, "run_in_group"),
                            ((n,), {"shape": (n + 1, 1)}, "shape")):
        try:
            make_mesh(*args, device_type="cpu", **kw)
        except ValueError as e:
            _check(match in str(e), str(e))
        else:
            raise AssertionError(f"make_mesh{args} {kw} did not raise")
    return {}


def _batch(n, sig, dtype):
    return np.stack([sig] * max(4, 2 * n)).astype(dtype)


def _sharded_float(n, mesh, sig):
    batch = _batch(n, sig, np.float32)
    fn = mfcc_sharded_fn(mesh, CFG)
    cep, energy = fn(shard_streams(batch, mesh))
    got = gather(cep, mesh, fn.layout)
    want = float_ops.mfcc_batch(torch.from_numpy(batch), CFG)
    _check(got.shape == want.shape, f"{got.shape} vs {want.shape}")
    err = float((got - want).abs().max())
    _check(err <= HALO_TOL, f"vs the unsharded chain: {err}")
    e_want = float((want[..., 0] ** 2).mean())
    _check(abs(float(energy) - e_want) <= 1e-6 * e_want,
           f"energy {float(energy)} vs {e_want}")
    return {"cep": got.numpy(), "energy": float(energy),
            "impl": fn.selected_impl}


def _sharded_int(n, mesh, sig):
    batch = _batch(n, sig, np.int32)
    fn = mfcc_sharded_fn(mesh, CFG, int_path=True)
    cep, energy = fn(shard_streams(batch, mesh))
    got = gather(cep, mesh, fn.layout)
    _check(torch.equal(got, MFCC(device="cpu").int(batch)), "vs MFCC.int")
    return {"cep": got.numpy(), "energy": float(energy)}


def _streaming_int(n, mesh, sig):
    S, C = max(4, 2 * n), 700
    step = streaming_sharded_fn(mesh, CFG, int_path=True)
    state = shard_state(streaming.init_state(S, CFG, torch.int32,
                                             device="cpu"), mesh)
    outs = [[] for _ in range(S)]
    for lo, hi in [(0, 700), (700, 1192)]:
        chunk = np.zeros((S, C), np.int32)
        chunk[:, : hi - lo] = sig[lo:hi]
        feats, mask, state = step(shard_rows(chunk, mesh), state, None,
                                  shard_rows(np.full(S, hi - lo), mesh))
        feats, mask = gather(feats, mesh, "dp"), gather(mask, mesh, "dp")
        for s in range(S):
            outs[s].append(feats[s][mask[s]].numpy())
    return {"streams": [np.concatenate(o) for o in outs],
            "impl": step.selected_impl}


def _halo(n, mesh, sig, int_path):
    T = len(sig)
    Tp = pad_for_halo(T, mesh, CFG)
    padded = np.pad(sig.astype(np.float32), (0, Tp - T))
    batch = _batch(n, padded, np.int32 if int_path else np.float32)
    x = shard_streams(batch, mesh)
    local = mfcc_halo_fn(mesh, CFG, int_path=int_path)(x)
    frames = halo.halo_frames(x, mesh, CFG, int_path=int_path,
                              dtype=torch.float32)
    out = gather(local, mesh)
    _check(out.shape == (len(batch), Tp // CFG.hop, CFG.nceptrums),
           f"shape {out.shape}")
    # this rank's frames are its streams' whole-signal frames on the same
    # rows, zero-extended past the last shard: the exchange is exact
    rows = shard_rows(batch, mesh)
    whole = (framing.preemphasis_int(rows) if int_path
             else framing.preemphasis(rows))
    whole = torch.cat([whole, whole.new_zeros(
        whole.shape[0], CFG.nfft - CFG.hop)], dim=1)
    j = meshlib.axis_index(mesh, "sp")
    nrow = Tp // meshlib.axis_size(mesh, "sp") // CFG.hop
    block = framing.extract_frames(whole, CFG.nfft, CFG.hop)[
        :, j * nrow:(j + 1) * nrow].contiguous()
    _check(torch.equal(frames, block), "halo frames vs the whole signal's")
    F = CFG.n_frames(Tp)
    if int_path:
        _check(torch.equal(out[:, :F], MFCC(device="cpu").int(batch)),
               "vs MFCC.int on the padded signal")
    else:
        _check(torch.equal(local, float_ops.mfcc_frames(block, CFG)),
               "vs the chain on the same frame rows")
        err = float((out[:, :F] - float_ops.mfcc_batch(
            torch.from_numpy(batch), CFG)).abs().max())
        _check(err <= HALO_TOL, f"vs the unsharded chain: {err}")
    return {"out": out.numpy(), "padded": padded}


def _kernel_interpret(n, mesh, sig):
    S = 2 * n
    batch = np.stack([sig] * S).astype(np.int32)
    fn = mfcc_sharded_fn(mesh, CFG, int_path=True, use_kernels="interpret")
    icep = gather(fn(shard_streams(batch, mesh))[0], mesh, fn.layout)
    fnf = mfcc_sharded_fn(mesh, CFG, use_kernels="interpret")
    fcep, energy = fnf(shard_streams(batch.astype(np.float32), mesh))
    fcep = gather(fcep, mesh, fnf.layout)
    fe = MFCC(device="cpu")
    _check(torch.equal(icep, fe.int(batch)), "INT vs MFCC.int")
    _check(torch.equal(fcep, fe(torch.from_numpy(batch.astype(np.float32)))),
           "float vs MFCC (K1's plain version)")
    return {"int": icep.numpy(), "float": fcep.numpy(),
            "impl": (fn.selected_impl, fnf.selected_impl)}


def _kernel_interpret_odd_hop(n, mesh, sig):
    from mfcc_tpu_torch.ops import float_fused
    odd = MFCCConfig(step=171)
    batch = np.stack([np.roll(sig, 7 * s) for s in range(2 * n)]).astype(
        np.float32)
    fn = mfcc_sharded_fn(mesh, odd, use_kernels="interpret")
    cep, energy = fn(shard_streams(batch, mesh))
    cep = gather(cep, mesh, fn.layout)
    want = float_fused.mfcc_recomp_t_plain(torch.from_numpy(batch), odd)
    _check(torch.equal(cep, want), "vs K6's plain version unsharded")
    e_want = float((want[..., 0].double() ** 2).mean())
    _check(abs(float(energy) - e_want) <= 1e-6 * e_want,
           f"energy {float(energy)} vs {e_want}")
    return {"cep": cep.numpy(), "batch": batch, "impl": fn.selected_impl}


def _streaming_interpret(n, mesh, sig):
    S = 2 * meshlib.axis_size(mesh, "dp")
    step = streaming_sharded_fn(mesh, CFG, int_path=True,
                                use_kernels="interpret")
    sm = StreamingMFCC(int_path=True, device="cpu")
    state, ref = shard_state(sm.init(S), mesh), sm.init(S)
    outs, same = [[] for _ in range(S)], True
    for lo, hi in [(0, 596), (596, 1192)]:          # two full 596-chunks
        chunk = np.stack([sig[lo:hi]] * S).astype(np.int32)
        feats, mask, state = step(shard_rows(chunk, mesh), state)
        rf, rm, ref = sm.step(torch.from_numpy(chunk), ref)
        feats, mask = gather(feats, mesh, "dp"), gather(mask, mesh, "dp")
        full = [gather(t, mesh, "dp") for t in state]
        same = same and torch.equal(mask, rm) and torch.equal(
            feats[rm], rf[rm]) and all(torch.equal(a, b)
                                       for a, b in zip(full, ref))
        for s in range(S):
            outs[s].append(feats[s][mask[s]].numpy())
    _check(same, "vs the unsharded StreamingMFCC steps")
    return {"streams": [np.concatenate(o) for o in outs],
            "impl": step.selected_impl}


def _graft_entry(n, mesh, sig):
    x = np.random.default_rng(0).integers(-2000, 2000, (16, 3912)).astype(
        np.float32)
    fn = mfcc_sharded_fn(mesh, CFG)
    got = gather(fn(shard_streams(x, mesh))[0], mesh, fn.layout)
    _check(tuple(got.shape) == (16, 21, 32), f"shape {got.shape}")
    err = float((got - float_ops.mfcc_batch(torch.from_numpy(x),
                                            CFG)).abs().max())
    _check(err <= HALO_TOL, f"vs the unsharded chain: {err}")
    return {"cep": got.numpy(), "x": x}


def _dryrun(n, mesh, sig):
    line = dryrun._dryrun_rank("cpu")
    _check(line.startswith("dryrun_multichip OK"), line)
    return {"line": line}


def _auto_routing(n, mesh, sig):
    batch = _batch(n, sig, np.float32)
    fn = mfcc_sharded_fn(mesh, CFG, use_kernels="auto")
    chain = mfcc_sharded_fn(mesh, CFG, use_kernels=False)
    x = shard_streams(batch, mesh)
    got = gather(fn(x)[0], mesh, fn.layout)
    want = gather(chain(x)[0], mesh, chain.layout)
    _check(fn.selected_impl == chain.selected_impl, fn.selected_impl)
    _check(torch.equal(got, want), "auto vs the chain on a CPU rank")
    return {"impl": fn.selected_impl}


TWINS = {
    "device_count_contract": _device_count_contract,
    "make_mesh_rejects_oversubscription": _oversubscription,
    "sharded_matches_unsharded": _sharded_float,
    "sharded_int_path_exact": _sharded_int,
    "sharded_streaming_int_exact": _streaming_int,
    "halo_exchange_matches_unsharded":
        lambda n, m, s: _halo(n, m, s, False),
    "halo_int_exact": lambda n, m, s: _halo(n, m, s, True),
    "sharded_kernel_interpret_routing": _kernel_interpret,
    "sharded_kernel_interpret_odd_hop": _kernel_interpret_odd_hop,
    "streaming_sharded_kernel_interpret_routing": _streaming_interpret,
    "graft_entry_single": _graft_entry,
    "graft_dryrun_multichip": _dryrun,
    "sharded_kernel_routing_auto": _auto_routing,
}


def _twins(n, sig):
    """Every twin on this rank: {name: {"error": traceback or None,
    "data": what the test checks}}."""
    mesh = make_mesh(device_type="cpu")
    out = {}
    for name, fn in TWINS.items():
        try:
            out[name] = {"error": None, "data": fn(n, mesh, sig)}
        except Exception:
            out[name] = {"error": traceback.format_exc(), "data": None}
    return out


def _raise_on_rank_one():
    import sys
    import torch.distributed as dist
    if dist.get_rank() == 1:
        print("rank one says goodbye", file=sys.stderr, flush=True)
        raise RuntimeError("the rank failed on purpose")
    dist.barrier()


def _die_on_rank_one():
    import os
    import torch.distributed as dist
    if dist.get_rank() == 1:
        os._exit(3)
    dist.all_reduce(torch.ones(1))       # never completes


# -- the tests -------------------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def group(request, audio_int16):
    n = request.param
    results = bootstrap.run_in_group(_twins, n,
                                     args=(n, audio_int16.astype(np.int64)),
                                     device_type="cpu", timeout=TIMEOUT)
    return n, results


def _data(group, name):
    """Rank 0's data of a twin; fails with the first rank's traceback."""
    n, results = group
    for rank, res in enumerate(results):
        assert res[name]["error"] is None, (
            f"rank {rank} of {n}:\n{res[name]['error']}")
    return results[0][name]["data"]


def _jax():
    import jax.numpy as jnp
    from mfcc_tpu import MFCCConfig as JaxConfig, parallel
    return jnp, parallel, JaxConfig()


def test_device_count_contract(group):
    n, _ = group
    assert _data(group, "device_count_contract")["shape"] == \
        meshlib.mesh_shape(n)


def test_make_mesh_rejects_oversubscription(group):
    _data(group, "make_mesh_rejects_oversubscription")


def test_sharded_matches_unsharded(group, audio_int16):
    d = _data(group, "sharded_matches_unsharded")
    assert d["impl"] == "chain/dp-sp+halo"
    jnp, jpar, jcfg = _jax()
    jmesh = jpar.make_mesh(1)
    batch = _batch(group[0], audio_int16, np.float32)
    jcep, jenergy = jpar.mfcc_sharded_fn(jmesh, jcfg)(jnp.asarray(batch))
    assert np.abs(d["cep"] - np.asarray(jcep)).max() <= TOL_JAX
    assert abs(d["energy"] - float(jenergy)) <= 1e-6 * float(jenergy)
    want = float_ref.mfcc_float(audio_int16, CFG)
    for s in range(len(batch)):
        assert np.abs(d["cep"][s] - want).max() <= GATE


def test_sharded_int_path_exact(group, audio_int16):
    d = _data(group, "sharded_int_path_exact")
    jnp, jpar, jcfg = _jax()
    batch = _batch(group[0], audio_int16, np.int32)
    jcep, _ = jpar.mfcc_sharded_fn(jpar.make_mesh(1), jcfg, int_path=True)(
        jnp.asarray(batch))
    assert np.array_equal(d["cep"], np.asarray(jcep))
    want = int_ref.mfcc_int(audio_int16.astype(np.int64), CFG)
    for s in range(len(batch)):
        assert np.array_equal(d["cep"][s], want)


def test_sharded_streaming_int_exact(group, audio_int16):
    d = _data(group, "sharded_streaming_int_exact")
    assert d["impl"] == "chain-step/dp"
    want = int_ref.mfcc_int(audio_int16.astype(np.int64), CFG)
    for got in d["streams"]:
        assert np.array_equal(got, want)


def _halo_vs_jax(group, name, int_path):
    d = _data(group, name)
    jnp, jpar, jcfg = _jax()
    jmesh = jpar.make_mesh(1)
    batch = _batch(group[0], d["padded"], np.int32 if int_path
                   else np.float32)
    jout = np.asarray(jpar.mfcc_halo_fn(jmesh, jcfg, int_path=int_path)(
        jnp.asarray(batch)))
    F = CFG.n_frames(len(d["padded"]))
    if int_path:
        assert np.array_equal(d["out"], jout)
        want = int_ref.mfcc_int(d["padded"].astype(np.int64), CFG)
        assert all(np.array_equal(o[:F], want) for o in d["out"])
    else:
        assert np.abs(d["out"] - jout).max() <= TOL_JAX
        want = float_ref.mfcc_float(d["padded"], CFG)
        assert max(np.abs(o[:F] - want).max() for o in d["out"]) <= GATE


def test_halo_exchange_matches_unsharded(group):
    _halo_vs_jax(group, "halo_exchange_matches_unsharded", False)


def test_halo_int_exact(group):
    _halo_vs_jax(group, "halo_int_exact", True)


def test_sharded_kernel_interpret_routing(group, audio_int16):
    d = _data(group, "sharded_kernel_interpret_routing")
    assert d["impl"] == ("kernel/all-ranks(interpret)",) * 2
    want = int_ref.mfcc_int(audio_int16.astype(np.int64), CFG)
    assert all(np.array_equal(c, want) for c in d["int"])
    wantf = float_ref.mfcc_float(audio_int16, CFG)
    assert max(np.abs(c - wantf).max() for c in d["float"]) <= GATE
    jnp, jpar, jcfg = _jax()
    batch = np.stack([audio_int16] * 2 * group[0]).astype(np.float32)
    jcep, _ = jpar.mfcc_sharded_fn(jpar.make_mesh(1), jcfg)(
        jnp.asarray(batch))
    assert np.abs(d["float"] - np.asarray(jcep)).max() <= TOL_JAX


def test_sharded_kernel_interpret_odd_hop(group):
    """An odd hop on the kernel route: K6's plain version on every rank,
    the whole batch equal to it unsharded (checked on the ranks) and
    within GATE of the oracle."""
    d = _data(group, "sharded_kernel_interpret_odd_hop")
    assert d["impl"] == "kernel/all-ranks(interpret)"
    odd = MFCCConfig(step=171)
    oracle = np.stack([float_ref.mfcc_float(s, odd) for s in d["batch"]])
    assert d["cep"].shape == oracle.shape
    assert np.abs(d["cep"] - oracle).max() <= GATE


def test_streaming_sharded_kernel_interpret_routing(group, audio_int16):
    d = _data(group, "streaming_sharded_kernel_interpret_routing")
    assert d["impl"] == "fused-stream-kernel/dp(interpret)"
    want = int_ref.mfcc_int(audio_int16.astype(np.int64), CFG)
    for got in d["streams"]:
        assert np.array_equal(got, want[: got.shape[0]])
        assert got.shape[0] == 5          # every frame of the 1192 samples


def test_graft_entry_single(group):
    """The JAX entry's batch, sharded.  On its white noise JAX's f32 chain
    itself reads 9.6e-5 from the float64 oracle, so the two are held to
    the float contract (GATE) each, not to TOL_JAX of each other."""
    d = _data(group, "graft_entry_single")
    jnp, jpar, jcfg = _jax()
    from mfcc_tpu.ops import float_ops as jfloat_ops
    want = np.asarray(jfloat_ops.mfcc_batch(jnp.asarray(d["x"]), jcfg))
    assert want.shape == d["cep"].shape == (16, 21, 32)
    oracle = np.stack([float_ref.mfcc_float(s, CFG) for s in d["x"]])
    assert np.abs(d["cep"] - oracle).max() <= GATE
    assert np.abs(want - oracle).max() <= GATE


def test_graft_dryrun_multichip(group):
    line = _data(group, "graft_dryrun_multichip")["line"]
    assert "backend=gloo" in line and "kernel-routed=kernel/all-ranks" in line


def test_sharded_kernel_routing_auto(group):
    """"auto" on a CPU rank takes the chain, as the JAX package's
    ``use_kernels="auto"`` does off a TPU."""
    assert _data(group, "sharded_kernel_routing_auto")["impl"] == \
        "chain/dp-sp+halo"


def test_dryrun_multichip_4(capfd):
    line = dryrun.dryrun_multichip(4, device_type="cpu", timeout=TIMEOUT)
    assert line.startswith("dryrun_multichip OK: mesh={'dp': 2, 'sp': 2}")
    assert line in capfd.readouterr().out


def test_a_rank_that_raises_fails_the_run():
    with pytest.raises(RuntimeError,
                       match="(?s)rank 1 of 2: exit code 1.*goodbye.*failed on purpose"):
        bootstrap.run_in_group(_raise_on_rank_one, 2, device_type="cpu",
                               timeout=TIMEOUT)


def test_a_rank_that_dies_fails_the_run_without_a_hang():
    """Rank 1 exits while rank 0 waits in a collective: the run fails at
    once (rank 0 is terminated), not at the timeout."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2: exit code 3"):
        bootstrap.run_in_group(_die_on_rank_one, 2, device_type="cpu",
                               timeout=TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT
