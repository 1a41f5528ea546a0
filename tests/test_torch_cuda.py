"""The torch package's CUDA kernels on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one.  The file imports neither JAX nor ``mfcc_tpu``, so it runs on
a host that has only PyTorch with CUDA:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from mfcc_tpu_torch import MFCC, MFCCConfig
from mfcc_tpu_torch.ops import fladder, float_ops
from mfcc_tpu_torch.ref import float_ref

# Kernel and plain version both compute in float64 and round once to f32:
# they differ by an f32 ulp at most (measured 2.4e-7 at the headline
# shape); 5e-5 is the JAX K1's own bound against the oracle.
TOL = 5e-5
GATE = 5e-4

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _tonal(S, T, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000.0
    base = (9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
            + 4000 * np.sin(2 * np.pi * 900 * t))
    return np.round(np.clip(base[None] + rng.integers(-1500, 1500, (S, T)),
                            -32768, 32767)).astype(np.float32)


@pytest.mark.parametrize("nfft,hop", [(256, 86), (512, 170), (1024, 340)])
def test_kernel_matches_plain(dev, nfft, hop):
    cfg = MFCCConfig(nfft=nfft, step=hop)
    sig = _tonal(8, 16000, seed=nfft)
    for x, floor in ((sig.astype(np.int16), 0.0), (sig, 0.0),
                     (sig / np.float32(32768), 0.0),
                     (np.zeros((1, 16000), np.float32), 1.0)):
        xt = torch.from_numpy(np.array(x)).to(dev)
        before = fladder.LAUNCHES
        got = fladder.mfcc_float_ladder(xt, cfg, floor)
        torch.cuda.synchronize()
        assert fladder.LAUNCHES == before + 1
        want = fladder.mfcc_float_ladder_plain(xt, cfg, floor)
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= TOL


def test_ragged_tiles_and_leading_dims(dev):
    """Frame counts that are not a multiple of the block's tile, 1-D and
    3-D inputs."""
    cfg = MFCCConfig()
    for T in (512, 512 + 170, 512 + 5 * 170 + 3, 9000):
        x = torch.from_numpy(_tonal(3, T, seed=T)).to(dev)
        got = fladder.mfcc_float_ladder(x, cfg)
        want = fladder.mfcc_float_ladder_plain(x, cfg)
        assert got.shape == (3, cfg.n_frames(T), 32)
        assert (got - want).abs().max().item() <= TOL
    x = torch.from_numpy(_tonal(4, 3000, seed=1)).to(dev)
    full = fladder.mfcc_float_ladder(x, cfg)
    assert torch.equal(fladder.mfcc_float_ladder(x[1], cfg), full[1])
    assert torch.equal(fladder.mfcc_float_ladder(x.reshape(2, 2, -1), cfg),
                       full.reshape(2, 2, *full.shape[1:]))


def test_module_route_on_card(dev):
    sig = _tonal(4, 16000, seed=3)
    fe = MFCC().to(dev)
    before = fladder.LAUNCHES
    got = fe(torch.from_numpy(sig.astype(np.int16)).to(dev))
    assert fladder.LAUNCHES == before + 1
    want = np.stack([float_ref.mfcc_float(s) for s in sig])
    assert np.abs(got.cpu().numpy() - want).max() <= GATE
    # the plain chain on the card holds the gate too (full-f32 matmuls)
    chain = float_ops.mfcc_batch(torch.from_numpy(sig).to(dev))
    assert np.abs(chain.cpu().numpy() - want).max() <= GATE


def test_loaded_operators_on_card(dev):
    """Operators loaded through state_dict reach the kernel: a mel whose
    bands span every bin changes K1's band limits."""
    mel = torch.zeros(257, 32, dtype=torch.float64)
    mel[:256] = 1.0 / 256
    state = MFCC().state_dict()
    state["mel"] = mel
    fe = MFCC().to(dev)
    fe.load_state_dict(state)
    x = torch.from_numpy(_tonal(2, 8000, seed=4)).to(dev)
    ops = fladder.LadderOperators(fe.ladder_window, fe.mel[:256], fe.dct,
                                  fe.mel_band)
    want = fladder.mfcc_float_ladder_plain(x, fe.cfg, operators=ops)
    assert (fe(x) - want).abs().max().item() <= TOL
    chain = float_ops.mfcc_batch(x.cpu(), fe.cfg)
    assert not torch.equal(fe(x).cpu(), chain)


def test_input_device_must_match_on_card(dev):
    x = torch.zeros(1, 4000)
    with pytest.raises(ValueError, match="cpu.*cuda"):
        MFCC().to(dev)(x)
    with pytest.raises(ValueError, match="cuda.*cpu"):
        MFCC()(x.to(dev))


def test_wrapper_checks_on_card(dev):
    x = torch.zeros(2, 4000, device=dev)
    with pytest.raises(TypeError, match="int16 or float32"):
        fladder.mfcc_float_ladder(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        fladder.mfcc_float_ladder(torch.zeros(4000, 2, device=dev).t())
    ops = fladder.default_operators(MFCCConfig(), dev)
    with pytest.raises(ValueError, match="operator window"):
        fladder.mfcc_float_ladder(x, operators=ops._replace(
            window=ops.window.float()))
    with pytest.raises(ValueError, match="operator band"):
        fladder.mfcc_float_ladder(x, operators=ops._replace(
            band=ops.band.long()))


def test_unported_kernels_raise_on_card(dev):
    x = torch.zeros(1, 4000, device=dev)
    with pytest.raises(NotImplementedError, match="K5"):
        MFCC(precision="fast").to(dev)(x)
    with pytest.raises(NotImplementedError, match="K6"):
        MFCC(MFCCConfig(step=171)).to(dev)(x)
    with pytest.raises(NotImplementedError, match="K5"):
        MFCC(precision="fast").to(dev).frames(torch.zeros(1, 2, 512,
                                                          device=dev))
