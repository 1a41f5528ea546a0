"""The torch package's ``utils`` (VAD, lifter, the debug taps, the
profiler trace) and ``compat`` against the JAX package's on the same numpy
inputs: twins of tests/test_utils.py's VAD and lifter tests, on numpy and
on tensors, and the intermediates key by key.

Tolerances: INT taps and the VAD element-exact; the lifter's scale in
float64 (numpy) equal, in float32 (tensors) within 1e-6 relative; the
float taps up to the filterbank (linear stages: an f32 FFT in another
library) within REL = 1e-6 of the largest value, log, DCT and cepstra
within TOL_JAX = 1e-4 (tests/test_torch_pipeline.py).
"""

import filecmp
import json
import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import mfcc_tpu
from mfcc_tpu.utils import debug as jdebug
from mfcc_tpu.utils import liftering as jliftering, vad as jvad

from mfcc_tpu_torch import MFCC, MFCCConfig
from mfcc_tpu_torch.ref import int_ref
from mfcc_tpu_torch.utils import debug, liftering, vad
from mfcc_tpu_torch.utils.liftering import lifter
from mfcc_tpu_torch.utils.vad import (DEFAULT_THRESHOLD, has_voice,
                                      voice_activity_power)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_JAX = 1e-4
REL = 1e-6
LINEAR = ("emph", "frames", "window", "fft_re", "fft_im", "power",
          "filterbank")


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_vad_matches_reference_semantics(as_tensor):
    """Sum of c0^2 over the central third (cepstrum.c:168-176)."""
    cep = np.zeros((9, 16), dtype=np.int64)
    cep[:, 0] = np.arange(9) * 1000
    wrap = torch.from_numpy if as_tensor else np.asarray
    # central third = frames 3,4,5 -> 3000^2 + 4000^2 + 5000^2
    assert int(voice_activity_power(wrap(cep.copy()))) == 9e6 + 16e6 + 25e6
    assert not bool(has_voice(wrap(cep.copy())))
    cep[4, 0] = 20000                    # 4e8 > 1e8 threshold
    assert bool(has_voice(wrap(cep.copy())))
    assert DEFAULT_THRESHOLD == jvad.DEFAULT_THRESHOLD == int(1e8)


@pytest.mark.parametrize("dtype", [np.int32, np.int16, np.float32])
def test_vad_matches_jax(dtype):
    rng = np.random.default_rng(5)
    cep = rng.integers(-30000, 30000, (3, 2, 13, 32)).astype(dtype)
    want = np.asarray(jvad.voice_activity_power(cep))
    assert np.array_equal(voice_activity_power(cep), want)
    got = voice_activity_power(torch.from_numpy(cep))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert np.array_equal(has_voice(cep, 4e8),
                          np.asarray(jvad.has_voice(cep, 4e8)))


def test_lifter_formula():
    """1 + (L/2) sin(pi n / L), L=22 (lift.py:12-26)."""
    x = np.ones((2, 32))
    out = lifter(x, L=22)
    n = np.arange(32)
    np.testing.assert_allclose(out[0], 1 + 11 * np.sin(np.pi * n / 22))
    assert lifter(x, L=0) is x           # L<=0 no-op
    t = torch.ones(2, 32)
    assert lifter(t, L=0) is t


@pytest.mark.parametrize("L", [22, 7, -1])
def test_lifter_matches_jax(L):
    rng = np.random.default_rng(L + 100)
    cep = rng.standard_normal((4, 5, 32))
    assert np.array_equal(lifter(cep, L), jliftering.lifter(cep, L))
    c32 = cep.astype(np.float32)
    got = lifter(torch.from_numpy(c32), L)
    want = np.asarray(jliftering.lifter(jnp.asarray(c32), L))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= REL * np.abs(want).max()


def test_lifter_of_int_cepstra_is_float():
    got = lifter(torch.arange(32, dtype=torch.int32)[None], 22)
    assert got.dtype == torch.float32
    assert np.allclose(got.numpy(), lifter(np.arange(32)[None], 22))


def _tap_signal(audio_int16):
    return np.stack([audio_int16, np.roll(audio_int16, 333)])


def test_float_intermediates_match_jax(audio_int16):
    sig = _tap_signal(audio_int16)
    want = jdebug.float_intermediates(sig)
    got = debug.float_intermediates(sig)
    assert list(got) == list(want)                 # the same ten keys
    for key, w in want.items():
        w, g = np.asarray(w), got[key].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, key
        bound = REL * np.abs(w).max() if key in LINEAR else TOL_JAX
        assert np.abs(g - w).max() <= bound, key
    assert torch.equal(got["cepstra"], got["dct"][..., :32])


def test_int_intermediates_match_jax(audio_int16):
    sig = _tap_signal(audio_int16)
    want = jdebug.int_intermediates(sig.astype(np.int64))
    got = debug.int_intermediates(torch.from_numpy(sig.astype(np.int64)))
    assert list(got) == list(want)
    for key, w in want.items():
        w = np.asarray(w)
        assert got[key].dtype == torch.int32, key
        assert np.array_equal(got[key].numpy(), w), key
    assert torch.equal(got["cepstra"], MFCC(device="cpu").int(sig))


def test_intermediates_of_other_configs(audio_int16):
    """Another geometry: the INT taps end in the oracle's cepstra (JAX's
    eager INT taps take ~20 s a call, so the default config alone is held
    to them key by key), the float taps match JAX's."""
    cfg = MFCCConfig(nfft=256, step=100, nfilters=16, nceptrums=12)
    jcfg = mfcc_tpu.MFCCConfig(nfft=256, step=100, nfilters=16,
                               nceptrums=12)
    got = debug.int_intermediates(audio_int16, cfg)
    assert np.array_equal(got["cepstra"].numpy(), int_ref.mfcc_int(
        audio_int16.astype(np.int64), cfg))
    assert got["power"].shape == (got["frames"].shape[0], 128)
    wantf = jdebug.float_intermediates(audio_int16, jcfg)
    gotf = debug.float_intermediates(audio_int16, cfg)
    assert np.abs(gotf["cepstra"].numpy()
                  - np.asarray(wantf["cepstra"])).max() <= TOL_JAX


def test_mfcc_intermediates_method(audio_int16):
    """``MFCC.intermediates`` as the JAX package's: the float taps on the
    module's device; its cepstra are the chain's."""
    fe = MFCC(device="cpu")
    got = fe.intermediates(audio_int16)
    want = mfcc_tpu.MFCC().intermediates(audio_int16)
    assert set(got) == set(want)
    assert np.abs(got["cepstra"].numpy()
                  - np.asarray(want["cepstra"])).max() <= TOL_JAX
    assert got["emph"].device.type == "cpu"
    assert torch.equal(got["frames"], debug.float_intermediates(
        audio_int16)["frames"])
    assert np.abs(got["cepstra"].numpy()
                  - fe(audio_int16).numpy()).max() <= TOL_JAX


def test_profile_trace_writes_a_trace(tmp_path, audio_int16):
    with debug.profile_trace(str(tmp_path / "trace")) as logdir:
        MFCC(device="cpu")(audio_int16)
    with open(os.path.join(logdir, "trace.json")) as f:
        trace = json.load(f)
    assert logdir == str(tmp_path / "trace")
    assert any(e.get("ph") == "X" for e in trace["traceEvents"])


def test_utils_modules_are_the_counterparts():
    assert set(("debug", "liftering", "vad")) <= set(dir(
        __import__("mfcc_tpu_torch.utils", fromlist=["*"])))
    assert liftering.lifter is lifter and vad.has_voice is has_voice


def test_compat_is_a_bit_identical_copy():
    """``compat/`` and ``io/wav.py`` are the JAX package's files byte for
    byte."""
    for name in ("compat/__init__.py", "compat/librosa_mfcc.py",
                 "io/wav.py"):
        assert filecmp.cmp(os.path.join(REPO, "mfcc_tpu", name),
                           os.path.join(REPO, "mfcc_tpu_torch", name),
                           shallow=False), name


@pytest.mark.parametrize("name", ["io/capture.py", "utils/viewer.py"])
def test_capture_and_viewer_are_copies(name):
    """``io/capture.py`` and ``utils/viewer.py`` are the JAX package's files
    byte for byte, except that their docstrings cite the reference's
    sources by their path in the reference repository, not in a checkout
    on one machine."""
    def read(pkg):
        with open(os.path.join(REPO, pkg, name), "rb") as f:
            return f.read()
    want, got = read("mfcc_tpu"), read("mfcc_tpu_torch")
    assert got == re.sub(rb"\(/\w+/reference/", b"(reference ", want, count=1)
    code = lambda src: src.split(b'"""', 2)[2]      # after the docstring
    assert code(got) == code(want) and len(code(got)) > 1000
