"""Framing and the float_ops chain of the torch package against the JAX
package on the CPU, on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfcc_tpu import MFCCConfig as JaxConfig
from mfcc_tpu.ops import float_ops as jfloat, framing as jframing
from mfcc_tpu.ref import float_ref

from mfcc_tpu_torch import MFCCConfig
from mfcc_tpu_torch.ops import float_ops, framing

# f32 matmuls and FFTs sum in another order in each framework; on the
# ~1e1-magnitude cepstra and log-mel values that is ~1e-5 (measured 7.6e-6),
# so 1e-4 leaves 10x headroom while still catching a wrong operator.
TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))   # a writable copy


@pytest.fixture(scope="module")
def ints():
    """Integer-valued int16-range samples (as float32), 3 streams."""
    rng = np.random.default_rng(11)
    return rng.integers(-32768, 32768, (3, 2000)).astype(np.float32)


@pytest.fixture(scope="module")
def normalized():
    rng = np.random.default_rng(12)
    return rng.uniform(-1.0, 1.0, (3, 2000)).astype(np.float32)


@pytest.fixture(scope="module")
def sig2(audio_int16):
    a = audio_int16.astype(np.float32)
    return np.stack([a, np.round(np.roll(a, 250) * 0.7)])


def test_preemphasis_integer_input_equal(ints):
    """Integer samples: x - 0.96875*prev is exact in f32, so equal."""
    got = framing.preemphasis(_t(ints)).numpy()
    assert np.array_equal(got, np.asarray(jframing.preemphasis(ints)))
    carry = ints[:, -1].copy()
    got = framing.preemphasis(_t(ints), carry=_t(carry)).numpy()
    want = np.asarray(jframing.preemphasis(ints, carry=jnp.asarray(carry)))
    assert np.array_equal(got, want)


def test_preemphasis_normalized_close(normalized):
    """Non-integer samples: XLA may contract the multiply-subtract into an
    FMA (one rounding instead of two), so 1e-6 absolute on [-1, 1] values
    (a few f32 ulps)."""
    got = framing.preemphasis(_t(normalized)).numpy()
    want = np.asarray(jframing.preemphasis(normalized))
    assert np.abs(got - want).max() <= 1e-6
    carry = np.float32([0.5, -0.25, 0.0])
    got = framing.preemphasis(_t(normalized), carry=_t(carry)).numpy()
    want = np.asarray(jframing.preemphasis(normalized,
                                           carry=jnp.asarray(carry)))
    assert np.abs(got - want).max() <= 1e-6


def test_preemphasis_matches_oracle_first_sample(ints):
    got = framing.preemphasis(_t(ints[0]).double()).numpy()
    assert np.array_equal(got, float_ref.preemphasis(ints[0]))


@pytest.mark.parametrize("nfft,hop,wl", [(512, 170, None), (512, 160, 400),
                                         (256, 86, None), (1024, 340, None)])
def test_extract_frames_equal(ints, nfft, hop, wl):
    got = framing.extract_frames(_t(ints), nfft, hop, windowlen=wl).numpy()
    want = np.asarray(jframing.extract_frames(ints, nfft, hop, windowlen=wl))
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    idx = framing.frame_indices(ints.shape[-1], nfft, hop, wl).numpy()
    assert np.array_equal(idx, jframing.frame_indices(ints.shape[-1], nfft,
                                                      hop, wl))


def test_short_signal_error_text():
    with pytest.raises(ValueError) as port:
        framing.extract_frames(torch.zeros(2, 500), 512, 170)
    with pytest.raises(ValueError) as ref:
        jframing.extract_frames(jnp.zeros((2, 500)), 512, 170)
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError) as port:
        framing.frame_indices(300, 512, 170, 400)
    with pytest.raises(ValueError) as ref:
        jframing.frame_indices(300, 512, 170, 400)
    assert str(port.value) == str(ref.value)


CHAIN_CONFIGS = {
    "default": {},
    "nfft256": dict(nfft=256, step=86),
    "windowed400": dict(step=160, window_samples=400),
    "mic": dict(nceptrums=16),
}


@pytest.mark.parametrize("method", ["dft", "rfft"])
@pytest.mark.parametrize("name", sorted(CHAIN_CONFIGS))
def test_mfcc_batch_and_frames_match_jax(sig2, method, name):
    kw = CHAIN_CONFIGS[name]
    cfg, jcfg = MFCCConfig(**kw), JaxConfig(**kw)
    got = float_ops.mfcc_batch(_t(sig2), cfg, method=method).numpy()
    want = np.asarray(jfloat.mfcc_batch(sig2, jcfg, method=method))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL
    emph = np.asarray(jframing.preemphasis(sig2))
    frames = np.asarray(jframing.extract_frames(emph, jcfg.nfft, jcfg.hop,
                                                windowlen=jcfg.windowlen))
    got = float_ops.mfcc_frames(_t(frames), cfg, method=method).numpy()
    want = np.asarray(jfloat.mfcc_frames(frames, jcfg, method=method))
    assert np.abs(got - want).max() <= TOL


def test_power_and_log_mel_match_jax(sig2):
    emph = np.asarray(jframing.preemphasis(sig2))
    frames = np.asarray(jframing.extract_frames(emph, 512, 170))
    got = float_ops.power_spectrum_frames(_t(frames)).numpy()
    want = np.asarray(jfloat.power_spectrum_frames(frames))
    assert got.shape == want.shape == (2, 5, 257)
    # power reaches ~3e5: compare relative to each frame's peak, where f32
    # DFT rounding is ~1e-7 (measured 1.8e-8)
    rel = np.abs(got - want) / np.abs(want).max(-1, keepdims=True)
    assert rel.max() <= 1e-5
    got = float_ops.log_mel_frames(_t(frames)).numpy()
    want = np.asarray(jfloat.log_mel_frames(frames))
    assert np.abs(got - want).max() <= TOL


def test_mel_floor_matches_jax(sig2):
    silent = np.concatenate([sig2[:1], np.zeros_like(sig2[:1])])
    got = float_ops.mfcc_batch(_t(silent), mel_floor=1.0).numpy()
    want = np.asarray(jfloat.mfcc_batch(silent, mel_floor=1.0))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got[1]).max() == 0.0


def test_chain_against_oracle(sig2):
    want = np.stack([float_ref.mfcc_float(s) for s in sig2])
    got = float_ops.mfcc_batch(_t(sig2)).numpy()
    assert np.abs(got - want).max() <= 5e-5   # measured 1.0e-5 (f32 chain)


@pytest.mark.parametrize("precision", ["high", "default", "bf16"])
def test_unported_precision_raises(sig2, precision):
    frames = torch.zeros(1, 512)
    for call in (
            lambda: float_ops.mfcc_batch(_t(sig2), precision=precision),
            lambda: float_ops.mfcc_frames(frames, precision=precision),
            lambda: float_ops.power_spectrum_frames(frames,
                                                    precision=precision),
            lambda: float_ops.log_mel_frames(frames, precision=precision)):
        with pytest.raises(NotImplementedError, match="not ported"):
            call()


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown method"):
        float_ops.mfcc_frames(torch.zeros(1, 512), method="fft")


def test_operators_are_cached_per_key():
    a = float_ops.default_operators(MFCCConfig(), torch.float32,
                                    torch.device("cpu"))
    b = float_ops.default_operators(MFCCConfig(), torch.float32,
                                    torch.device("cpu"))
    c = float_ops.default_operators(MFCCConfig(), torch.float64,
                                    torch.device("cpu"))
    assert a is b and c is not a and c.dft.dtype == torch.float64
    d = float_ops.default_operators(MFCCConfig(nceptrums=16), torch.float32,
                                    torch.device("cpu"))
    assert d.dct.shape == (32, 16) and a.dct.shape == (32, 32)
