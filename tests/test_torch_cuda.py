"""The torch package's CUDA kernels on the card: K1 (float) against its
plain version within TOL, K2 and K3 (INT) against theirs element for
element (``torch.equal``).

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one.  The file imports neither JAX nor ``mfcc_tpu``, so it runs on
a host that has only PyTorch with CUDA:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from mfcc_tpu_torch import MFCC, MFCCConfig, MIC_CONFIG
from mfcc_tpu_torch.ops import fladder, float_ops, framing, int_fused
from mfcc_tpu_torch.ref import float_ref, int_ref

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
        MFCC(device="cpu")(x.to(dev))


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


def test_default_device_is_the_card(dev):
    fe = MFCC()
    assert all(b.device.type == "cuda" for b in fe.buffers())
    assert MFCC(device="cpu").window.device.type == "cpu"


def _int_inputs(seed=0):
    """(name, (S, T) input): tonal int16, full-range int16, silence, int32
    outside int16 range, one frame exactly, a ragged tail."""
    rng = np.random.default_rng(seed)
    return [
        ("tonal int16", _tonal(4, 16000, seed).astype(np.int16)),
        ("full-range int16", rng.integers(-32768, 32768, (3, 4000))
         .astype(np.int16)),
        ("silence", np.zeros((2, 3000), np.int16)),
        ("wide int32", rng.integers(-2 ** 31, 2 ** 31, (3, 5000))
         .astype(np.int32)),
        ("T=512", rng.integers(-32768, 32768, (5, 512)).astype(np.int16)),
        ("T=681", rng.integers(-32768, 32768, (5, 681)).astype(np.int16)),
    ]


@pytest.mark.parametrize("cfg", [MFCCConfig(), MIC_CONFIG,
                                 MFCCConfig(nfilters=16, nceptrums=16),
                                 MFCCConfig(step=160)],
                         ids=["default", "mic", "nfilters16", "hop160"])
def test_int_kernel_matches_plain(dev, cfg):
    """K2 equals its plain version element for element."""
    for name, x in _int_inputs():
        xt = torch.from_numpy(x).to(dev)
        before = int_fused.LAUNCHES
        got = int_fused.mfcc_int_fused(xt, cfg)
        torch.cuda.synchronize()
        assert int_fused.LAUNCHES == before + 1
        want = int_fused.mfcc_int_fused_plain(xt, cfg)
        assert got.dtype == torch.int32
        assert got.shape == (x.shape[0], cfg.n_frames(x.shape[1]),
                             cfg.nceptrums), name
        assert torch.equal(got, want), name


def test_int_frames_kernel_matches_plain(dev):
    """K3 on frames of several streams with two leading axes, and on int32
    frames outside int16 range."""
    x = torch.from_numpy(_tonal(4, 8000, 5).astype(np.int32)).to(dev)
    frames = framing.extract_frames(framing.preemphasis_int(x), 512, 170)
    frames = frames.reshape(2, 2, *frames.shape[1:]).contiguous()
    wide = torch.from_numpy(np.random.default_rng(6).integers(
        -2 ** 31, 2 ** 31, (3, 7, 512)).astype(np.int32)).to(dev)
    for f in (frames, wide):
        before = int_fused.LAUNCHES
        got = int_fused.mfcc_int_fused_frames(f)
        torch.cuda.synchronize()
        assert int_fused.LAUNCHES == before + 1
        assert got.shape == f.shape[:-1] + (32,)
        assert torch.equal(got, int_fused.mfcc_int_fused_frames_plain(f))
    assert torch.equal(int_fused.mfcc_int_fused_frames(frames).reshape(
        4, -1, 32), int_fused.mfcc_int_fused(x))


def test_int_module_on_card(dev):
    """MFCC().int on the card is element-exact with the oracle, and runs
    K2; int_frames runs K3."""
    sig = _tonal(2, 16000, 7).astype(np.int16)
    fe = MFCC()
    before = int_fused.LAUNCHES
    got = fe.int(torch.from_numpy(sig).to(dev))
    assert int_fused.LAUNCHES == before + 1
    want = np.stack([int_ref.mfcc_int(s) for s in sig])
    assert np.array_equal(got.cpu().numpy(), want)
    assert np.array_equal(fe.int(sig).cpu().numpy(), want)   # numpy input
    frames = framing.extract_frames(framing.preemphasis_int(
        torch.from_numpy(sig.astype(np.int32)).to(dev)), 512, 170)
    before = int_fused.LAUNCHES
    assert np.array_equal(fe.int_frames(frames).cpu().numpy(), want)
    assert int_fused.LAUNCHES == before + 1


def test_int_wrapper_checks_on_card(dev):
    x = torch.zeros(2, 4000, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int16 or torch.int32"):
        int_fused.mfcc_int_fused(x.float())
    with pytest.raises(ValueError, match="contiguous"):
        int_fused.mfcc_int_fused(torch.zeros(4000, 2, dtype=torch.int32,
                                             device=dev).t())
    with pytest.raises(TypeError, match="int32"):
        int_fused.mfcc_int_fused_frames(torch.zeros(3, 512, device=dev))
    with pytest.raises(ValueError, match="frames"):
        int_fused.mfcc_int_fused_frames(torch.zeros(3, 256, dtype=torch.int32,
                                                    device=dev))
    with pytest.raises(ValueError, match="shorter than one frame"):
        int_fused.mfcc_int_fused(x[:, :511].contiguous())
