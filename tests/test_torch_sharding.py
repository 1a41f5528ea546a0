"""The torch package's ``parallel/`` in one process: a world of one gloo
rank on the CPU, against the JAX package's sharded functions on a 1-device
mesh and against the unsharded port, on the same numpy inputs; the mesh
factoring and its errors; the bootstrap's environment.

Tolerances: INT element-exact everywhere; the dp routes and the halo at
world size 1 run the unsharded computation, so they are bit-identical to
the unsharded port; float is within TOL_JAX = 1e-4 of JAX (both f32 DFT
matmul chains on the CPU, as tests/test_torch_pipeline.py) and within
GATE = 5e-4 of the float64 oracle (the float contract); the energy within
1e-6 relative of JAX's (an f32 mean against a float64 sum).  The 2- and
4-rank runs are in tests/test_torch_multichip_subprocess.py.
"""

import os
import shutil
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax.numpy as jnp

from mfcc_tpu import parallel as jparallel, streaming as jstreaming
from mfcc_tpu.config import MFCCConfig as JaxConfig
from mfcc_tpu.ref import float_ref, int_ref

from mfcc_tpu_torch import MFCC, MFCCConfig, StreamingMFCC, StreamState
from mfcc_tpu_torch import streaming
from mfcc_tpu_torch.ops import float_ops
from mfcc_tpu_torch.parallel import (bootstrap, gather, make_mesh,
                                     mfcc_halo_fn, mfcc_sharded_fn,
                                     pad_for_halo, shard_rows, shard_state,
                                     shard_streams, streaming_sharded_fn)
from mfcc_tpu_torch.parallel import mesh as meshlib

CFG = MFCCConfig()
JCFG = JaxConfig()
TOL_JAX = 1e-4
GATE = 5e-4


@pytest.fixture(scope="module")
def mesh():
    """A world of one gloo rank on the CPU, and its (1, 1) mesh."""
    tmp = tempfile.mkdtemp(prefix="mfcc_group_test_")
    bootstrap.init_group(0, 1, os.path.join(tmp, "store"), backend="gloo",
                         device_type="cpu", timeout=60)
    try:
        yield make_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def jmesh():
    return jparallel.make_mesh(1)


@pytest.fixture(scope="module")
def batch(audio_int16):
    """Four streams: the fixture signal, rolled and scaled."""
    a = audio_int16.astype(np.float32)
    return np.stack([a, np.round(np.roll(a, 250) * 0.7),
                     np.round(np.roll(a, -97) * 0.5), -a])


# -- the mesh and the bootstrap --------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_shape_factoring_matches_jax(n):
    jshape = tuple(jparallel.make_mesh(n).shape.values())
    assert meshlib.mesh_shape(n) == jshape
    assert meshlib.mesh_shape(n, axes=("dp",)) == (n,)
    assert meshlib.mesh_shape(n, shape=(1, n)) == (1, n)


def test_mesh_shape_rejects_a_shape_that_misses_ranks():
    with pytest.raises(ValueError, match="shape"):
        meshlib.mesh_shape(4, shape=(3, 1))
    with pytest.raises(ValueError, match="shape"):
        meshlib.mesh_shape(4, shape=(4,))


def test_make_mesh_rejects_oversubscription(mesh):
    """The world-size check that takes the place of JAX's device count:
    its message names bootstrap.run_in_group."""
    with pytest.raises(ValueError, match="run_in_group"):
        make_mesh(2)
    with pytest.raises(ValueError, match="shape"):
        make_mesh(1, shape=(2, 1))


def test_mesh_of_one_rank(mesh):
    assert mesh.mesh_dim_names == ("dp", "sp")
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.device_type == "cpu"
    assert meshlib.mesh_device(mesh) == torch.device("cpu")
    assert meshlib.axis_size(mesh, "dp") == 1
    assert meshlib.axis_size(mesh, "tp") == 1
    assert meshlib.axis_index(mesh, "sp") == 0
    assert meshlib.axis_index(mesh, "tp") == 0
    one = make_mesh(1, axes=("dp",), device_type="cpu")
    assert tuple(one.shape) == (1,) and meshlib.axis_size(one, "sp") == 1
    with pytest.raises(ValueError, match="device_type"):
        make_mesh(device_type="tpu")
    if not torch.cuda.is_available():     # the default is the card
        with pytest.raises(RuntimeError, match="device_type=\"cpu\""):
            make_mesh()


def test_group_env_names_the_rank_and_store():
    env = bootstrap.group_env(3, 4, "/x/store")
    assert env == {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "3",
                   "LOCAL_WORLD_SIZE": "4", bootstrap.STORE_ENV: "/x/store"}


def test_rank_device():
    assert bootstrap.rank_device(1, "cpu", "gloo", 2) == torch.device("cpu")
    with pytest.raises(ValueError, match="device_type"):
        bootstrap.rank_device(0, "tpu", "gloo", 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device_type=\"cpu\""):
            bootstrap.rank_device(0, "cuda", "gloo", 1)


def test_default_backend():
    """NCCL where each rank has a card of its own, else gloo."""
    assert bootstrap.default_backend("cpu", 1) == "gloo"
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert bootstrap.default_backend("cuda", n + 1) == "gloo"
    if n:
        assert bootstrap.default_backend("cuda", n) == "nccl"


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a CUDA card")
def test_run_in_group_defaults_to_the_card():
    """Ranks run on the card unless the caller asks for the CPU: on a host
    without one ``run_in_group`` raises at once, before it spawns."""
    with pytest.raises(RuntimeError, match="device_type=\"cpu\""):
        bootstrap.run_in_group(print, 2)


def test_shard_and_gather_at_world_one(mesh, batch):
    x = shard_streams(batch, mesh)
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert np.array_equal(x.numpy(), batch)
    assert torch.equal(gather(x, mesh), x)
    assert torch.equal(gather(x, mesh, "flat"), x)
    flags = torch.tensor([True, False, True, False])
    assert torch.equal(gather(shard_rows(flags, mesh), mesh, "dp"), flags)
    with pytest.raises(ValueError, match="layout"):
        gather(x, mesh, "sp-dp")


def test_local_block_checks(mesh, batch):
    fn = mfcc_sharded_fn(mesh, CFG)
    with pytest.raises(ValueError, match="S_loc, T_loc"):
        fn(batch[0])
    cep, _ = fn(batch)                    # numpy is put on the rank's device
    assert cep.shape == (4, 5, 32)


# -- the sharded batch --------------------------------------------------------------

def _jax_sharded(jmesh, batch, **kw):
    fn = jparallel.mfcc_sharded_fn(jmesh, JCFG, **kw)
    cep, energy = fn(jparallel.shard_streams(jnp.asarray(batch), jmesh))
    return np.asarray(cep), float(energy)


def test_sharded_float_matches_jax_and_unsharded(mesh, jmesh, batch):
    fn = mfcc_sharded_fn(mesh, CFG)
    assert fn.selected_impl == "chain/dp-sp" and fn.layout == "dp-sp"
    cep, energy = fn(shard_streams(batch, mesh))
    got = gather(cep, mesh, fn.layout)
    want = float_ops.mfcc_batch(torch.from_numpy(batch), CFG)
    assert torch.equal(got, want)
    jcep, jenergy = _jax_sharded(jmesh, batch)
    assert np.abs(got.numpy() - jcep).max() <= TOL_JAX
    oracle = np.stack([float_ref.mfcc_float(s, CFG) for s in batch])
    assert np.abs(got.numpy() - oracle).max() <= GATE
    assert energy.dtype == torch.float32 and energy.shape == ()
    assert abs(float(energy) - jenergy) <= 1e-6 * jenergy
    assert float(energy) == pytest.approx(
        float((want[..., 0] ** 2).mean()), rel=1e-6)


def test_sharded_int_exact(mesh, jmesh, batch):
    x = batch.astype(np.int32)
    fn = mfcc_sharded_fn(mesh, CFG, int_path=True)
    cep, energy = fn(shard_streams(x, mesh))
    assert cep.dtype == torch.int32
    assert torch.equal(cep, MFCC(device="cpu").int(x))
    jcep, jenergy = _jax_sharded(jmesh, x, int_path=True)
    assert np.array_equal(cep.numpy(), jcep)
    for s in range(4):
        assert np.array_equal(cep[s].numpy(),
                              int_ref.mfcc_int(x[s].astype(np.int64), CFG))
    assert abs(float(energy) - jenergy) <= 1e-6 * jenergy


def test_sharded_kernel_interpret_routing(mesh, jmesh, batch):
    """The kernel route forced through the kernels' plain versions: INT
    element-exact, float K1's plain version (the unsharded module on the
    CPU) bit for bit."""
    fn = mfcc_sharded_fn(mesh, CFG, int_path=True, use_kernels="interpret")
    assert fn.selected_impl == "kernel/all-ranks(interpret)"
    assert fn.layout == "flat"
    x = batch.astype(np.int32)
    cep, _ = fn(shard_streams(x, mesh))
    assert torch.equal(cep, MFCC(device="cpu").int(x))
    fnf = mfcc_sharded_fn(mesh, CFG, use_kernels="interpret")
    cepf, energy = fnf(shard_streams(batch, mesh))
    assert torch.equal(cepf, MFCC(device="cpu")(torch.from_numpy(batch)))
    jcep, jenergy = _jax_sharded(jmesh, batch)
    assert np.abs(cepf.numpy() - jcep).max() <= TOL_JAX
    oracle = np.stack([float_ref.mfcc_float(s, CFG) for s in batch])
    assert np.abs(cepf.numpy() - oracle).max() <= GATE
    assert abs(float(energy) - jenergy) <= 1e-5 * jenergy


def test_sharded_routing_policy(mesh):
    """"auto" takes the chain off the card (as JAX off its TPU); False is
    the chain; "interpret" raises outside the kernels' family, as in
    JAX."""
    assert mfcc_sharded_fn(mesh, CFG).selected_impl == "chain/dp-sp"
    assert mfcc_sharded_fn(mesh, CFG, use_kernels=False,
                           int_path=True).selected_impl == "chain/dp-sp"
    with pytest.raises(ValueError, match="interpret"):
        mfcc_sharded_fn(mesh, MFCCConfig(step=160, window_samples=400),
                        use_kernels="interpret")
    with pytest.raises(ValueError, match="interpret"):
        mfcc_sharded_fn(mesh, CFG, precision="split",
                        use_kernels="interpret")
    with pytest.raises(ValueError, match="use_kernels"):
        mfcc_sharded_fn(mesh, CFG, use_kernels=True)
    # an odd hop is in the float kernels' family (K6), as in JAX
    odd = MFCCConfig(step=171)
    assert mfcc_sharded_fn(mesh, odd).selected_impl == "chain/dp-sp"
    assert mfcc_sharded_fn(mesh, odd, use_kernels="interpret"
                           ).selected_impl == "kernel/all-ranks(interpret)"


def test_sharded_odd_hop_interpret_matches_jax(mesh, jmesh, batch):
    """An odd hop on the kernel route runs K6's plain version (K1's at
    that hop) where JAX runs its recompute kernel in interpret mode: bit
    for bit the port's ``mfcc_recomp_t_plain``, within GATE of JAX's
    (f32 dense DFT against float64 inside, as
    tests/test_torch_float_fused.py holds K6) and of the oracle."""
    from mfcc_tpu_torch.ops import float_fused
    odd, jodd = MFCCConfig(step=171), JaxConfig(step=171)
    fn = mfcc_sharded_fn(mesh, odd, use_kernels="interpret")
    cep, energy = fn(shard_streams(batch, mesh))
    assert cep.shape == (4, odd.n_frames(batch.shape[1]), 32)
    assert torch.equal(cep, float_fused.mfcc_recomp_t_plain(
        torch.from_numpy(batch), odd))
    jfn = jparallel.mfcc_sharded_fn(jmesh, jodd, use_kernels="interpret")
    jcep, _ = jfn(jparallel.shard_streams(jnp.asarray(batch), jmesh))
    assert np.abs(cep.numpy() - np.asarray(jcep)).max() <= GATE
    oracle = np.stack([float_ref.mfcc_float(s, odd) for s in batch])
    assert np.abs(cep.numpy() - oracle).max() <= GATE
    assert float(energy) == pytest.approx(
        float((cep[..., 0].double() ** 2).mean()), rel=1e-6)


# -- the halo ----------------------------------------------------------------------

@pytest.mark.parametrize("int_path", [False, True], ids=["float", "int"])
def test_halo_matches_jax_and_unsharded(mesh, jmesh, audio_int16, int_path):
    T = len(audio_int16)
    Tp = pad_for_halo(T, mesh, CFG)
    assert Tp == jparallel.pad_for_halo(T, jmesh, JCFG)
    padded = np.pad(audio_int16.astype(np.float32), (0, Tp - T))
    x = np.stack([padded, np.roll(padded, 3)])
    if int_path:
        x = x.astype(np.int32)
    fn = mfcc_halo_fn(mesh, CFG, int_path=int_path)
    out = fn(shard_streams(x, mesh))
    assert out.shape == (2, Tp // CFG.hop, CFG.nceptrums)
    jout = np.asarray(jparallel.mfcc_halo_fn(jmesh, JCFG, int_path=int_path)(
        jparallel.shard_streams(jnp.asarray(x), jmesh)))
    F = CFG.n_frames(Tp)
    if int_path:
        assert np.array_equal(out.numpy(), jout)
        assert torch.equal(out[:, :F], MFCC(device="cpu").int(x))
        assert np.array_equal(out[0, :F].numpy(),
                              int_ref.mfcc_int(padded.astype(np.int64), CFG))
    else:
        assert np.abs(out.numpy() - jout).max() <= TOL_JAX
        assert torch.equal(out[:, :F],
                           float_ops.mfcc_batch(torch.from_numpy(x), CFG))
        assert np.abs(out[0, :F].numpy()
                      - float_ref.mfcc_float(padded, CFG)).max() <= GATE


@pytest.mark.parametrize("int_path", [False, True], ids=["float", "int"])
def test_halo_frames_are_the_whole_signals(mesh, audio_int16, int_path):
    """``halo.halo_frames`` at world size 1: the zero-extended signal's
    T/hop frames, emphasized as the chain emphasizes."""
    from mfcc_tpu_torch.ops import framing
    from mfcc_tpu_torch.parallel import halo
    Tp = pad_for_halo(len(audio_int16), mesh, CFG)
    x = torch.from_numpy(np.pad(audio_int16, (0, Tp - len(audio_int16))
                                ).astype(np.int32))[None]
    got = halo.halo_frames(x, mesh, CFG, int_path=int_path,
                           dtype=torch.float32)
    emph = (framing.preemphasis_int(x) if int_path
            else framing.preemphasis(x.float()))
    emph = torch.cat([emph, emph.new_zeros(1, CFG.nfft - CFG.hop)], dim=1)
    want = framing.extract_frames(emph, CFG.nfft, CFG.hop)[:, : Tp // CFG.hop]
    assert got.dtype == (torch.int32 if int_path else torch.float32)
    assert torch.equal(got, want)


def test_halo_checks_the_shard_length(mesh):
    fn = mfcc_halo_fn(mesh, CFG)
    with pytest.raises(ValueError, match="pad_for_halo"):
        fn(np.zeros((1, 1192), np.float32))          # not a hop multiple
    with pytest.raises(ValueError, match="pad_for_halo"):
        fn(np.zeros((1, 340), np.float32))           # shorter than nfft


# -- sharded streaming -----------------------------------------------------------

def _jax_stream_run(step, state, chunks, lengths, int_path):
    outs = []
    for chunk, n in zip(chunks, lengths):
        S = chunk.shape[0]
        feats, mask, state = step(
            jnp.asarray(chunk), state, jnp.zeros((S,), bool),
            None if n is None else jnp.full((S,), n, jnp.int32))
        outs.append((np.asarray(feats), np.asarray(mask)))
    return outs, state


@pytest.mark.parametrize("int_path", [True, False], ids=["int", "float"])
def test_streaming_sharded_matches_jax(mesh, jmesh, audio_int16, int_path):
    """Chunked streaming under dp sharding, a full chunk then a
    length-limited flush (as test_sharding.py's INT test): INT features,
    the mask and the state equal JAX's; float within TOL_JAX; the streams
    equal the oracle."""
    S, C = 4, 700
    sig = audio_int16.astype(np.int64)
    dt = np.int32 if int_path else np.float32
    chunks, lengths = [], []
    for lo, hi in [(0, 700), (700, 1192)]:
        chunk = np.zeros((S, C), dt)
        chunk[:, : hi - lo] = sig[lo:hi]
        chunks.append(chunk)
        lengths.append(None if hi - lo == C else hi - lo)
    jstep = jparallel.streaming_sharded_fn(jmesh, JCFG, int_path=int_path)
    jstate = jstreaming.init_state(S, JCFG,
                                   jnp.int32 if int_path else jnp.float32)
    jouts, jstate = _jax_stream_run(jstep, jstate, chunks, lengths, int_path)

    step = streaming_sharded_fn(mesh, CFG, int_path=int_path)
    assert step.selected_impl == "chain-step/dp"
    state = shard_state(streaming.init_state(
        S, CFG, torch.int32 if int_path else torch.float32, device="cpu"),
        mesh)
    outs = [[] for _ in range(S)]
    for chunk, n, (jf, jm) in zip(chunks, lengths, jouts):
        feats, mask, state = step(
            shard_rows(chunk, mesh), state, None,
            None if n is None else shard_rows(np.full(S, n), mesh))
        assert np.array_equal(mask.numpy(), jm)
        if int_path:
            assert np.array_equal(feats.numpy(), jf)
        else:
            m = mask.numpy()
            assert np.abs(feats.numpy()[m] - jf[m]).max() <= TOL_JAX
        for s in range(S):
            outs[s].append(feats[s][mask[s]].numpy())
    for f in StreamState._fields:
        assert np.array_equal(getattr(state, f).numpy(),
                              np.asarray(getattr(jstate, f)))
    want = (int_ref.mfcc_int(sig, CFG) if int_path
            else float_ref.mfcc_float(sig, CFG))
    for s in range(S):
        got = np.concatenate(outs[s])
        if int_path:
            assert np.array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= GATE


@pytest.mark.parametrize("int_path", [True, False], ids=["int", "float"])
def test_streaming_sharded_interpret_routing(mesh, audio_int16, int_path):
    """Full-chunk steps through the K4 step-level plain versions (the
    kernel route forced, "interpret"), equal to the unsharded
    ``StreamingMFCC`` steps and, INT, to the oracle; a flush step takes
    the chain."""
    S = 4
    sig = audio_int16.astype(np.int64)
    step = streaming_sharded_fn(mesh, CFG, int_path=int_path,
                                use_kernels="interpret")
    assert step.selected_impl == "fused-stream-kernel/dp(interpret)"
    sm = StreamingMFCC(int_path=int_path, device="cpu")
    state, ref_state = shard_state(sm.init(S), mesh), sm.init(S)
    outs = [[] for _ in range(S)]
    for lo, hi in [(0, 596), (596, 1192)]:          # two full 596-chunks
        chunk = torch.from_numpy(np.stack([sig[lo:hi]] * S).astype(
            np.int16))
        reset = torch.tensor([False, True, False, False]) if lo == 0 \
            else torch.zeros(S, dtype=torch.bool)
        feats, mask, state = step(chunk, state, reset)
        rf, rm, ref_state = sm.step(chunk, ref_state, reset)
        assert torch.equal(mask, rm) and torch.equal(feats[rm], rf[rm])
        for a, b in zip(state, ref_state):
            assert torch.equal(a, b)
        for s in range(S):
            outs[s].append(feats[s][mask[s]].numpy())
    if int_path:
        want = int_ref.mfcc_int(sig, CFG)
        for s in range(S):
            assert np.array_equal(np.concatenate(outs[s]), want[:6])
    # a flush step (lengths) takes the chain
    feats, mask, state = step(torch.zeros(S, 596, dtype=torch.int16), state,
                              None, torch.full((S,), 100))
    rf, rm, ref_state = sm.step(torch.zeros(S, 596, dtype=torch.int16),
                                ref_state, None, torch.full((S,), 100))
    assert torch.equal(mask, rm) and torch.equal(feats[rm], rf[rm])
    for a, b in zip(state, ref_state):
        assert torch.equal(a, b)


def test_streaming_interpret_raises_outside_the_family(mesh):
    with pytest.raises(ValueError, match="interpret"):
        streaming_sharded_fn(mesh, MFCCConfig(step=171),
                             use_kernels="interpret")
    assert streaming_sharded_fn(
        mesh, MFCCConfig(step=171)).selected_impl == "chain-step/dp"


def test_jax_carry_resumes_sharded(mesh, jmesh, audio_int16):
    """A JAX-layout carry (the JAX package's state after one chunk, as
    numpy) cut with ``shard_state`` resumes on the port's sharded step
    where JAX's own next step goes."""
    S, C = 4, 596
    sig = np.stack([np.roll(audio_int16, 11 * s) for s in range(S)]).astype(
        np.int32)
    jstep = jparallel.streaming_sharded_fn(jmesh, JCFG, int_path=True)
    jstate = jstreaming.init_state(S, JCFG, jnp.int32)
    reset = jnp.zeros((S,), bool)
    _, _, jstate = jstep(jnp.asarray(sig[:, :C]), jstate, reset)
    carry = {f: np.asarray(getattr(jstate, f)) for f in StreamState._fields}
    jf, jm, jstate = jstep(jnp.asarray(sig[:, C:2 * C]), jstate, reset)

    step = streaming_sharded_fn(mesh, CFG, int_path=True)
    feats, mask, state = step(shard_rows(sig[:, C:2 * C], mesh),
                              shard_state(carry, mesh))
    assert np.array_equal(mask.numpy(), np.asarray(jm))
    assert np.array_equal(feats.numpy(), np.asarray(jf))
    for f in StreamState._fields:
        assert np.array_equal(getattr(state, f).numpy(),
                              np.asarray(getattr(jstate, f)))
