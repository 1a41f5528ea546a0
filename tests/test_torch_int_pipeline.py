"""The torch package's INT path, ``MFCC.int`` and ``MFCC.int_frames`` on the
CPU, against the JAX package's ``MFCC`` (its ``int_ops`` route on the CPU),
its fused Pallas kernels in interpret mode, and the exact oracle.  The INT
contract is element-exact: tolerance 0 everywhere."""

import numpy as np
import pytest
import torch

import jax

import mfcc_tpu
from mfcc_tpu.ops import framing as jframing, pallas_int
from mfcc_tpu.ref import int_ref as jref

from mfcc_tpu_torch import MFCC, MFCCConfig, MIC_CONFIG
from mfcc_tpu_torch.ops import int_fused
from mfcc_tpu_torch.ref import int_ref as tref

CFG = MFCCConfig()


@pytest.fixture(scope="module")
def sig2(audio_int16):
    """Two streams, ~5 frames each: the rich fixture and a shifted, scaled
    copy (the sig2 of tests/test_pallas_interpret.py)."""
    a = audio_int16.astype(np.float32)
    return np.stack([a, np.round(np.roll(a, 250) * 0.7)])


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


@pytest.fixture(scope="module")
def fe():
    return MFCC(device="cpu")


def _oracle(sig, cfg=CFG):
    sig = np.asarray(sig, np.int64)
    return np.stack([tref.mfcc_int(s, cfg) for s in sig.reshape(
        -1, sig.shape[-1])]).reshape(sig.shape[:-1] + (-1, min(
            cfg.nceptrums, cfg.nfilters)))


def test_int_matches_jax_and_oracle(fe, sig2):
    x = sig2.astype(np.int64)
    got = fe.int(x)
    assert got.dtype == torch.int32 and got.shape == (2, 5, 32)
    got = got.numpy()
    assert np.array_equal(got, np.asarray(mfcc_tpu.MFCC().int(x)))
    assert np.array_equal(got, _oracle(x))
    want = np.stack([jref.mfcc_int(s) for s in x])
    assert np.array_equal(got, want)


def test_int_matches_pallas_v3_interpret(fe, sig2, cpu):
    x = sig2.astype(np.int32)
    with jax.default_device(cpu):
        want = np.asarray(pallas_int.mfcc_int_pallas_v3(x, interpret=True))
    assert np.array_equal(fe.int(x).numpy(), want)


def test_int_wide_input_matches_pallas_v3_interpret(fe, cpu):
    """int32 samples outside int16 range: the port, like the JAX kernel
    (its int16 wire), takes them mod 2^16; the unwrapped chain differs."""
    rng = np.random.default_rng(11)
    x = rng.integers(-2 ** 31, 2 ** 31, (2, 512 + 2 * 170)).astype(np.int32)
    with jax.default_device(cpu):
        want = np.asarray(pallas_int.mfcc_int_pallas_v3(x, interpret=True))
    got = fe.int(x).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, _oracle(x.astype(np.int16)))
    assert not np.array_equal(got, np.asarray(mfcc_tpu.MFCC().int(x)))


def test_int_frames_matches_jax_and_pallas_interpret(fe, sig2, cpu):
    """Frames from several streams with two leading axes, and int32 frames
    outside int16 range (the window product wraps mod 2^32)."""
    emph = np.asarray(jframing.preemphasis_int(sig2.astype(np.int32)))
    frames = np.asarray(jframing.extract_frames(emph, 512, 170))
    frames = np.stack([frames, frames[::-1]])            # (2, 2, 5, 512)
    rng = np.random.default_rng(12)
    wide = rng.integers(-2 ** 31, 2 ** 31, (3, 2, 512)).astype(np.int32)
    for x in (frames, wide):
        got = fe.int_frames(x)
        assert got.dtype == torch.int32
        assert got.shape == x.shape[:-1] + (32,)
        got = got.numpy()
        assert np.array_equal(got, np.asarray(mfcc_tpu.MFCC().int_frames(x)))
        with jax.default_device(cpu):
            want = np.asarray(pallas_int.mfcc_int_pallas_frames(
                x, interpret=True))
        assert np.array_equal(got, want)
    assert np.array_equal(fe.int_frames(frames).numpy()[0],
                          _oracle(sig2.astype(np.int64)))


@pytest.mark.parametrize("T", [512, 512 + 169, 512 + 4 * 170])
def test_int_edge_lengths(fe, audio_int16, T):
    """One frame exactly, a ragged tail one sample short of the next
    frame, and whole frames."""
    sig = np.concatenate([audio_int16, audio_int16])[:T].astype(np.int64)
    got = fe.int(sig).numpy()
    assert got.shape == (CFG.n_frames(T), 32)
    assert np.array_equal(got, tref.mfcc_int(sig))
    assert np.array_equal(got, np.asarray(mfcc_tpu.MFCC().int(sig)))


def test_int_short_signal_raises_like_jax(fe):
    x = np.zeros(511, np.int64)
    with pytest.raises(ValueError, match="shorter than one frame") as ours:
        fe.int(x)
    with pytest.raises(ValueError, match="shorter than one frame") as theirs:
        mfcc_tpu.MFCC().int(x)
    assert str(ours.value) == str(theirs.value)


def test_int_input_kinds_and_layouts(fe, sig2, audio_int16):
    """1-D, 2-D and 3-D input; numpy int64, float (truncated toward zero
    as in JAX), torch int16, lists."""
    x = sig2.astype(np.int64)
    base = fe.int(x)
    assert torch.equal(fe.int(torch.from_numpy(x.astype(np.int16))), base)
    assert torch.equal(fe.int(x.tolist()), base)
    assert torch.equal(fe.int(x[0]), base[0])
    x3 = np.stack([x, x[::-1]])
    got3 = fe.int(x3)
    assert got3.shape == (2, 2, 5, 32)
    assert torch.equal(got3[0], base) and torch.equal(got3[1], base.flip(0))
    frac = x + np.where(x >= 0, 0.75, -0.75)     # truncation recovers x
    assert torch.equal(fe.int(frac), base)
    assert torch.equal(fe.int(torch.from_numpy(frac.astype(np.float32))),
                       base)
    assert np.array_equal(fe.int(frac).numpy(),
                          np.asarray(mfcc_tpu.MFCC().int(frac)))
    assert torch.equal(fe.int(torch.from_numpy(x).t().contiguous().t()),
                       base)


@pytest.mark.parametrize("name", ["silence", "min_const", "alternating",
                                  "full_range"])
def test_int_adversarial_signals(fe, name):
    n = 512 + 4 * 170
    sig = {"silence": np.zeros(n, np.int64),
           "min_const": np.full(n, -32768, np.int64),
           "alternating": np.tile(np.array([32767, -32767], np.int64), n // 2),
           "full_range": np.random.default_rng(13).integers(
               -32768, 32768, n).astype(np.int64)}[name]
    got = fe.int(sig).numpy()
    assert np.array_equal(got, tref.mfcc_int(sig))
    assert np.array_equal(got, np.asarray(mfcc_tpu.MFCC().int(sig)))


@pytest.mark.parametrize("kw,route", [
    ({}, "fused"),
    (dict(nceptrums=16), "fused"),
    (dict(nfilters=16, nceptrums=16), "fused"),
    (dict(step=160), "fused"),
    (dict(width=15), "chain"),
    (dict(step=171), "chain"),
    (dict(window_precision=7), "chain"),
    (dict(step=160, window_samples=400), "chain"),
])
def test_int_routes_mirror_jax(audio_int16, kw, route):
    cfg = MFCCConfig(**kw)
    fe = MFCC(cfg, device="cpu")
    assert fe._int_route == route
    assert (route == "fused") == pallas_int.pallas_int_config_ok(
        mfcc_tpu.MFCCConfig(**kw))
    sig = audio_int16.astype(np.int64)
    if cfg.width < 16:
        sig = sig >> (16 - cfg.width)
    got = fe.int(sig).numpy()
    assert np.array_equal(got, tref.mfcc_int(sig, cfg))
    assert np.array_equal(got, np.asarray(
        mfcc_tpu.MFCC(mfcc_tpu.MFCCConfig(**kw)).int(sig)))


def test_mic_config(audio_int16):
    got = MFCC(MIC_CONFIG, device="cpu").int(audio_int16).numpy()
    assert got.shape == (5, 16)
    assert np.array_equal(got, tref.mfcc_int(audio_int16, MIC_CONFIG))


def test_int_module_on_cpu_never_launches(fe, sig2):
    before = dict(int_fused.LAUNCHES)
    fe.int(sig2)
    fe.int_frames(np.zeros((2, 512), np.int32))
    assert int_fused.LAUNCHES == before


def test_int_input_on_another_device_raises(fe):
    with pytest.raises(ValueError, match="meta.*cpu"):
        fe.int(torch.empty(2, 1000, dtype=torch.int32, device="meta"))
