"""The torch package's ``MFCC`` module against the JAX package's ``MFCC``
on the CPU, its routing, and the package's import and chip-smoke
contracts."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mfcc_tpu
from mfcc_tpu import tables as jtables
from mfcc_tpu.ref import float_ref

import mfcc_tpu_torch
from mfcc_tpu_torch import MFCC, MFCCConfig
from mfcc_tpu_torch.ops import fladder, framing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX's MFCC on the CPU is its f32 DFT-matmul chain (1.5e-5 from the
# oracle on this fixture); the port's K1 route computes in float64 (3e-6).
# Their difference is the f32 chain's rounding: 1e-4 leaves 6x headroom.
TOL_JAX = 1e-4
TOL_ORACLE = 5e-5


@pytest.fixture(scope="module")
def sig2(audio_int16):
    a = audio_int16.astype(np.float32)
    return np.stack([a, np.round(np.roll(a, 250) * 0.7)])


def _oracle(sig, cfg=MFCCConfig()):
    return np.stack([float_ref.mfcc_float(s, cfg) for s in sig])


def test_mfcc_matches_jax_and_oracle(sig2):
    want = _oracle(sig2)
    jax_out = np.asarray(mfcc_tpu.MFCC()(sig2))
    port = MFCC(device="cpu")(torch.from_numpy(sig2)).numpy()
    assert port.shape == jax_out.shape == (2, 5, 32)
    assert port.dtype == np.float32
    assert np.abs(port - jax_out).max() <= TOL_JAX
    assert np.abs(port - want).max() <= TOL_ORACLE
    assert np.abs(jax_out - want).max() <= TOL_ORACLE


def test_mfcc_int16_input_and_layouts(sig2, audio_int16):
    fe = MFCC(device="cpu")
    f32 = fe(torch.from_numpy(sig2)).numpy()
    i16 = fe(torch.from_numpy(sig2.astype(np.int16))).numpy()
    assert np.array_equal(f32, i16)
    one = fe(audio_int16).numpy()                        # numpy, 1-D
    assert one.shape == (5, 32)
    assert np.array_equal(one, fe(torch.from_numpy(sig2[:1])).numpy()[0])
    x3 = np.stack([sig2, sig2])
    assert fe(x3).shape == (2, 2, 5, 32)


def test_frames_matches_jax(sig2):
    from mfcc_tpu.ops import framing as jframing
    emph = np.asarray(jframing.preemphasis(sig2))
    frames = np.asarray(jframing.extract_frames(emph, 512, 170))
    want = np.asarray(mfcc_tpu.MFCC().frames(frames))
    got = MFCC(device="cpu").frames(
        torch.from_numpy(np.array(frames))).numpy()
    assert np.abs(got - want).max() <= TOL_JAX
    assert np.abs(got - _oracle(sig2)).max() <= TOL_ORACLE


def test_load_numpy_operators_from_jax_tables(sig2):
    fe = MFCC(device="cpu")
    base = fe(torch.from_numpy(sig2)).clone()
    base_frames = fe.frames(torch.zeros(1, 3, 512) + 1.0).clone()
    fe.load_numpy_operators({
        "window": jtables.float_window(512),
        "mel": jtables.float_mel_matrix(16000, 512, 32),
        "dct": jtables.dct2_ortho_matrix(32)})
    assert torch.equal(fe(torch.from_numpy(sig2)), base)
    assert torch.equal(fe.frames(torch.zeros(1, 3, 512) + 1.0), base_frames)


def test_load_numpy_operators_changes_output(sig2):
    fe = MFCC(device="cpu")
    base = fe(torch.from_numpy(sig2))
    fe.load_numpy_operators({"window": np.ones(512)})
    assert not torch.equal(fe(torch.from_numpy(sig2)), base)
    assert torch.equal(fe.dft[:, 0],
                       torch.full((512,), 1 / 512, dtype=torch.float64))
    assert torch.equal(fe.ladder_window,
                       torch.full((512,), 1 / 512, dtype=torch.float64))
    with pytest.raises(ValueError, match="unknown operators"):
        fe.load_numpy_operators({"dft": np.zeros((512, 514))})
    with pytest.raises(ValueError, match="shape"):
        fe.load_numpy_operators({"mel": np.zeros((10, 32))})


@pytest.mark.parametrize("kw,route", [
    ({}, "ladder"),
    (dict(mel_floor=1.0), "ladder"),
    (dict(method="rfft"), "chain"),
    (dict(dtype=torch.float64), "chain"),
    (dict(precision="fast"), "radix2"),
    (dict(cfg=MFCCConfig(step=171)), "recomp_t"),
    (dict(cfg=MFCCConfig(step=171), precision="fast"), "chain"),
    (dict(cfg=MFCCConfig(step=160, window_samples=400)), "chain"),
])
def test_routes_mirror_jax(sig2, kw, route):
    """The route of CUDA tensors is the JAX package's on its TPU: K1, K5 at
    3 passes ("radix2"), K6 ("recomp_t") or the chain.  On the CPU every
    route computes, K1's through its plain version and the others through
    the chain, and matches JAX's CPU route (the chain)."""
    fe = MFCC(**kw, device="cpu")
    assert fe._route == route
    cfg = kw.get("cfg", MFCCConfig())
    got = fe(torch.from_numpy(sig2)).numpy()
    assert got.shape == (2, cfg.n_frames(sig2.shape[-1]), cfg.nceptrums)
    jkw = {k: v for k, v in kw.items() if k not in ("cfg", "dtype")}
    jfe = mfcc_tpu.MFCC(mfcc_tpu.MFCCConfig(**{
        f: getattr(cfg, f) for f in ("nfft", "step", "window_samples")}),
        **jkw)
    want = np.asarray(jfe(sig2))
    assert np.abs(got - want).max() <= TOL_JAX


def test_fast_frames_route_flag(sig2):
    """``frames`` under ``precision="fast"`` takes K5-frames on the card
    (the JAX package's ``mfcc_pallas_frames_float`` route) and the chain on
    the CPU; other precisions and configs outside the family take the
    chain."""
    fe = MFCC(precision="fast", device="cpu")
    assert fe._frames_route == "radix2"
    assert MFCC(device="cpu")._frames_route == "chain"
    assert MFCC(precision="fast", mel_floor=1.0,
                device="cpu")._frames_route == "chain"
    frames = framing.extract_frames(framing.preemphasis(
        torch.from_numpy(sig2)), 512, 170)
    assert torch.equal(fe.frames(frames), MFCC(device="cpu").frames(frames))


@pytest.mark.parametrize("precision", ["high", "default", "bf16"])
def test_unported_precision_raises(sig2, precision):
    """``MFCC(precision=p)`` for "high", "default" and "bf16" on the CPU:
    the chain at full float32, what JAX's ``MFCC(precision=p)`` computes on
    its CPU, within the tolerances of "highest" (the test keeps the id of
    the raise test it replaced); the frames route too."""
    fe = MFCC(precision=precision, device="cpu")
    assert fe._route == fe._frames_route == "chain"
    assert fe._chain_precision == precision
    got = fe(torch.from_numpy(sig2)).numpy()
    want = np.asarray(mfcc_tpu.MFCC(precision=precision)(sig2))
    assert got.shape == want.shape == (2, 5, 32)
    assert np.abs(got - want).max() <= TOL_JAX
    assert np.abs(got - _oracle(sig2)).max() <= TOL_ORACLE
    frames = framing.extract_frames(framing.preemphasis(
        torch.from_numpy(sig2)), 512, 170)
    jf = np.asarray(mfcc_tpu.MFCC(precision=precision).frames(
        frames.numpy()))
    assert np.abs(fe.frames(frames).numpy() - jf).max() <= TOL_JAX
    with pytest.raises(ValueError, match="unknown precision"):
        MFCC(precision="bf17", device="cpu")


def test_default_device_is_the_card():
    """MFCC() puts its operators on the card; on a host without one it
    raises and names device="cpu", and never builds on the CPU silently."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MFCC()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MFCC(MFCCConfig(nfft=256, step=86), precision="fast")


def test_explicit_cpu_device():
    fe = MFCC(device="cpu")
    assert all(b.device.type == "cpu" for b in fe.buffers())
    assert MFCC(device=torch.device("cpu")).window.device.type == "cpu"


def test_cpu_module_never_launches(sig2):
    before = fladder.LAUNCHES
    MFCC(device="cpu")(torch.from_numpy(sig2))
    assert fladder.LAUNCHES == before


def test_exports():
    assert set(mfcc_tpu_torch.__all__) >= {"MFCC", "MFCCConfig",
                                          "DEFAULT_CONFIG", "MIC_CONFIG"}
    assert "nvcc" in mfcc_tpu_torch.__doc__
    assert isinstance(MFCC(device="cpu"), torch.nn.Module)
    fe = MFCC(device="cpu")
    names = {n for n, _ in fe.named_buffers()}
    assert names == {"window", "dft", "mel", "dct", "ladder_window",
                     "mel_band"}
    # the state is what the derived operators are built from
    assert set(fe.state_dict()) == {"window", "mel", "dct"}


def test_load_state_dict_rebuilds_derived_operators(sig2):
    """A loaded window and mel reach every route: K1's window/nfft and mel
    band limits and the chain's DFT operator are rebuilt, so forward and
    frames() agree with a module given the same operators directly."""
    mel = np.zeros((257, 32))
    mel[:256] = 1.0 / 256          # every band now spans all bins
    src = MFCC(device="cpu")
    state = src.state_dict()
    state["window"] = torch.ones(512, dtype=torch.float64)
    state["mel"] = torch.from_numpy(mel)
    fe = MFCC(device="cpu")
    fe.load_state_dict(state)
    ref = MFCC(device="cpu")
    ref.load_numpy_operators({"window": np.ones(512), "mel": mel})
    assert torch.equal(fe.dft, ref.dft)
    assert torch.equal(fe.dft[:, 0],
                       torch.full((512,), 1 / 512, dtype=torch.float64))
    assert torch.equal(fe.ladder_window, fe.window / 512)
    assert torch.equal(fe.mel_band, fladder.mel_bands(fe.mel[:256]))
    assert fe.mel_band[:, 0].eq(0).all() and fe.mel_band[:, 1].eq(256).all()
    # 8,192 terms: over the mel schedule's table, so the kernels take the
    # lane-per-filter loop
    assert fladder.schedule_of(fe._ladder_ops().mel) == (None, 0)
    x = torch.from_numpy(sig2)
    frames = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 3, 512)))
    assert torch.equal(fe(x), ref(x))
    assert torch.equal(fe.frames(frames), ref.frames(frames))
    assert not torch.equal(fe(x), src(x))
    assert not torch.equal(fe.frames(frames), src.frames(frames))


@pytest.mark.parametrize("method", ["forward", "frames"])
def test_input_on_another_device_raises(method):
    """A tensor is never copied to the operators' device: a CPU module
    given a tensor on another device raises and names both."""
    x = torch.empty(2, 3, 512, device="meta")
    with pytest.raises(ValueError, match="meta.*cpu"):
        getattr(MFCC(device="cpu"), method)(x)


def _run(args, cwd, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_import_leaves_jax_out():
    res = _run(["-c", "import sys, mfcc_tpu_torch, mfcc_tpu_torch.pipeline, "
                "mfcc_tpu_torch.kernels.build, mfcc_tpu_torch.ref.float_ref, "
                "mfcc_tpu_torch.ref.int_ref, mfcc_tpu_torch.ops.int_ops, "
                "mfcc_tpu_torch.ops.int_fused, mfcc_tpu_torch.streaming, "
                "mfcc_tpu_torch.server, mfcc_tpu_torch.io, "
                "mfcc_tpu_torch.io.transport, mfcc_tpu_torch.io.native, "
                "mfcc_tpu_torch.ops.stream_fused, "
                "mfcc_tpu_torch.ops.float_fused, "
                "mfcc_tpu_torch.ops.f64ish, mfcc_tpu_torch.ops.dense_fused, "
                "mfcc_tpu_torch.ops.warp_tails, mfcc_tpu_torch.parallel, "
                "mfcc_tpu_torch.parallel.dryrun, mfcc_tpu_torch.models, "
                "mfcc_tpu_torch.utils, mfcc_tpu_torch.compat, "
                "mfcc_tpu_torch.cli, mfcc_tpu_torch._entry, "
                "mfcc_tpu_torch.io.wav, mfcc_tpu_torch.io.capture, "
                "mfcc_tpu_torch.utils.viewer, mfcc_tpu_torch.examples, "
                "mfcc_tpu_torch.examples.quickstart, "
                "mfcc_tpu_torch.examples.int_walkthrough, "
                "mfcc_tpu_torch.examples.serving_demo, "
                "mfcc_tpu_torch.examples.server_loadtest; "
                "bad = sorted(m for m in sys.modules "
                "if m == 'jax' or m.startswith(('jax.', 'mfcc_tpu.')) "
                "or m == 'mfcc_tpu'); print(bad); sys.exit(1 if bad else 0)"],
               cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    res = _run(["chip_smoke.py"], cwd=REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run(["chip_smoke.py"], cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
