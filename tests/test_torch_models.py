"""The torch package's model family (``models/features.py``) against the
JAX package's models and the oracles: twins of tests/test_models_server.py's
model-family, librosa-recipe and differentiability tests, the models
against the JAX models on the same numpy inputs, and the gradients against
``jax.grad``.

Tolerances: the linear models (Spectrogram, MelSpectrogram) within REL =
1e-6 of the largest value (an f32 DFT matmul on each side), log-mel and
cepstra within TOL_JAX = 1e-4 (tests/test_torch_pipeline.py), INT
element-exact; gradients within GRAD_REL = 1e-4 of the largest component;
the librosa recipe within 2e-2 of the float64 recipe (the JAX test's own
bound: f32 against f64 on the dB scale) and 1e-4 relative of the JAX
model.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mfcc_tpu import MFCCConfig as JaxConfig, tables as jtables
from mfcc_tpu.compat import librosa_mfcc as lr
from mfcc_tpu.models import features as jfeatures

from mfcc_tpu_torch import MFCCConfig, MIC_CONFIG
from mfcc_tpu_torch.models import (IntMFCCFeatures, LibrosaMFCC,
                                   LogMelSpectrogram, MelSpectrogram,
                                   MFCCFeatures, Spectrogram, mic2mfcc_model,
                                   wav2mfcc_model)
from mfcc_tpu_torch.ops import float_ops
from mfcc_tpu_torch.ref import float_ref, int_ref

CFG = MFCCConfig()
JCFG = JaxConfig()
TOL_JAX = 1e-4
REL = 1e-6
GRAD_REL = 1e-4
FLOAT_MODELS = ("Spectrogram", "MelSpectrogram", "LogMelSpectrogram",
                "MFCCFeatures")


def _model(name, **kw):
    return globals()[name](CFG, device="cpu", **kw)


def test_model_family_consistency(audio_int16):
    """Each truncation of the pipeline agrees with the full oracle's
    intermediates."""
    _, inter = float_ref.mfcc_float(audio_int16, CFG,
                                    return_intermediates=True)
    spec = _model("Spectrogram")(audio_int16).numpy()
    assert spec.shape == (5, 257)
    assert np.abs(spec - inter["power"]).max() / inter["power"].max() < 1e-5

    mel = _model("MelSpectrogram")(audio_int16).numpy()
    assert np.abs(mel - inter["mel"]).max() / inter["mel"].max() < 1e-5

    logmel = _model("LogMelSpectrogram")(audio_int16).numpy()
    assert np.abs(logmel - np.log2(inter["mel"])).max() < 5e-4

    cep = _model("MFCCFeatures")(audio_int16).numpy()
    assert np.abs(cep - float_ref.mfcc_float(audio_int16, CFG)).max() < 5e-4

    icep = IntMFCCFeatures(CFG, device="cpu")(audio_int16.astype(np.int64))
    assert icep.dtype == torch.int32
    assert np.array_equal(icep.numpy(), int_ref.mfcc_int(
        audio_int16.astype(np.int64), CFG))


@pytest.mark.parametrize("name", FLOAT_MODELS)
def test_float_models_match_jax(name, audio_int16):
    sig = np.stack([audio_int16, np.roll(audio_int16, 77)])
    want = np.asarray(getattr(jfeatures, name)(JCFG)(sig))
    got = _model(name)(torch.from_numpy(sig))
    assert got.dtype == torch.float32 and got.shape == want.shape
    bound = (REL * np.abs(want).max() if name in ("Spectrogram",
                                                  "MelSpectrogram")
             else TOL_JAX)
    assert np.abs(got.numpy() - want).max() <= bound


def test_mel_floor_matches_jax():
    silent = np.zeros(1192, np.int16)
    for name in ("LogMelSpectrogram", "MFCCFeatures"):
        want = np.asarray(getattr(jfeatures, name)(JCFG, mel_floor=1.0)(
            silent))
        got = _model(name, mel_floor=1.0)(silent).numpy()
        assert np.isfinite(got).all() and np.array_equal(got, want)


def test_int_model_matches_jax(audio_int16):
    sig = np.stack([audio_int16, -audio_int16]).astype(np.int64)
    want = np.asarray(jfeatures.IntMFCCFeatures(JCFG)(sig))
    got = IntMFCCFeatures(CFG, device="cpu")(sig)
    assert np.array_equal(got.numpy(), want)


def test_librosa_torch_matches_numpy_recipe(audio_int16):
    want = lr.mfcc(audio_int16, sr=16000, hop=170, n_mfcc=32)
    got = LibrosaMFCC(device="cpu")(audio_int16).numpy()
    assert got.shape == want.shape
    assert np.abs(want - got).max() < 2e-2   # f32 vs f64, dB scale


def test_librosa_matches_jax_model(audio_int16):
    sig = np.stack([audio_int16, np.roll(audio_int16, 500)])
    want = np.asarray(jfeatures.LibrosaMFCC()(sig))
    got = LibrosaMFCC(device="cpu")(sig)
    assert got.shape == want.shape == (2, 32, 8)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    f = LibrosaMFCC(device="cpu")(torch.from_numpy(
        audio_int16.astype(np.float32) / 32768.0))
    assert torch.equal(f, got[0])


def test_differentiable_front_end(audio_int16):
    """The float pipeline is a trainable front-end: grads flow to the audio
    (and would flow to any learnable filterbank)."""
    x = torch.tensor(audio_int16[:852], dtype=torch.float32,
                     requires_grad=True)
    cep = float_ops.mfcc_batch(x[None], CFG, mel_floor=1e-6)
    (g,) = torch.autograd.grad((cep ** 2).sum(), x)
    assert g.shape == x.shape
    assert torch.isfinite(g).all()
    assert g.abs().max() > 0


@pytest.mark.parametrize("name", FLOAT_MODELS)
def test_gradients_match_jax_grad(name, audio_int16):
    """``torch.autograd.grad`` of the model's summed output against
    ``jax.grad`` of the same loss, with respect to the audio."""
    kw = {} if name in ("Spectrogram", "MelSpectrogram") else \
        {"mel_floor": 1e-6}
    jmodel = getattr(jfeatures, name)(JCFG, **kw)
    x = audio_int16.astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jmodel._fn(a)))(
        jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    (got,) = torch.autograd.grad(_model(name, **kw)(xt).sum(), xt)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    assert np.abs(got.numpy() - want).max() <= GRAD_REL * np.abs(want).max()


def test_gradients_reach_a_learnable_filterbank(audio_int16):
    model = MFCCFeatures(CFG, device="cpu")
    mel = torch.nn.Parameter(model.mel.clone())
    ops = model.operators()._replace(mel=mel)
    out = float_ops.mfcc_batch(torch.from_numpy(
        audio_int16.astype(np.float32)), CFG, operators=ops)
    (g,) = torch.autograd.grad(out.sum(), mel)
    assert g.shape == mel.shape and torch.isfinite(g).all()
    assert g.abs().max() > 0


def test_load_numpy_operators_from_jax_tables(audio_int16):
    model = MFCCFeatures(CFG, device="cpu")
    base = model(audio_int16).clone()
    model.load_numpy_operators({
        "window": jtables.float_window(512),
        "mel": jtables.float_mel_matrix(16000, 512, 32),
        "dct": jtables.dct2_ortho_matrix(32)[:, :32]})
    assert torch.equal(model(audio_int16), base)
    model.load_numpy_operators({"window": np.ones(512)})
    assert not torch.equal(model(audio_int16), base)
    assert set(dict(model.named_buffers())) == {"window", "dft", "mel", "dct"}
    with pytest.raises(ValueError, match="unknown"):
        model.load_numpy_operators({"dft": np.zeros((512, 514))})
    with pytest.raises(ValueError, match="shape"):
        model.load_numpy_operators({"mel": np.zeros((3, 3))})


def test_deployed_configurations():
    assert wav2mfcc_model(device="cpu").cfg == CFG
    mic = mic2mfcc_model(device="cpu")
    assert mic.cfg == MIC_CONFIG and mic.dct.shape == (32, 16)


def test_models_default_to_the_card():
    """``device=None`` is the card, as for ``MFCC``; a tensor on another
    device than the model's tables is refused."""
    if torch.cuda.is_available():
        assert wav2mfcc_model().window.device.type == "cuda"
        return
    for make in (wav2mfcc_model, lambda: IntMFCCFeatures(),
                 lambda: LibrosaMFCC(), lambda: Spectrogram()):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            make()


def test_models_are_modules_with_buffers():
    m = LogMelSpectrogram(CFG, device="cpu")
    assert isinstance(m, torch.nn.Module)
    assert m.state_dict().keys() == {"window", "dft", "mel", "dct"}
    lib = LibrosaMFCC(device="cpu")
    assert lib.state_dict().keys() == {"win", "mel", "dct"}
    assert isinstance(IntMFCCFeatures(device="cpu").mfcc, torch.nn.Module)
