"""K1 (``mfcc_tpu_torch.ops.fladder``) against the JAX package's K1
(``pallas_fladder.mfcc_float_ladder_pallas`` in interpret mode on the CPU,
as its own tests run it) and the float64 oracle.

On the CPU the wrapper runs K1's plain version; the CUDA kernel itself is
compared with it in test_torch_cuda.py (on the card) and by chip_smoke.py.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from mfcc_tpu import MFCCConfig as JaxConfig
from mfcc_tpu.ops import pallas_fladder
from mfcc_tpu.ref import float_ref

from mfcc_tpu_torch import KALDI_MFCC_HIRES, MFCCConfig
from mfcc_tpu_torch.ops import f64ish, fladder, float_fused

# The JAX K1 runs an f32 FFT (~1e-5 from the float64 oracle on these
# fixtures, its own test asserts 5e-5); the port computes in float64 and
# rounds once (~4e-6 from the oracle).  5e-5 is the JAX kernel's own bound.
TOL = 5e-5


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


@pytest.fixture(scope="module")
def sig2(audio_int16):
    """The JAX interpret tests' two-stream fixture."""
    a = audio_int16.astype(np.float32)
    return np.stack([a, np.round(np.roll(a, 250) * 0.7)])


def _tonal(T, S=2, seed=5):
    """The bench's tonal signal shape (integer-valued), as the JAX nfft-256
    interpret test builds it: white noise alone leaves near-zero mel bands
    at nfft 256 whose log2 is ill-conditioned for any f32 formulation."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000.0
    base = (9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
            + 4000 * np.sin(2 * np.pi * 900 * t))
    return np.round(np.clip(base[None] + rng.integers(-1500, 1500, (S, T)),
                            -32768, 32767)).astype(np.float32)


def _oracle(sig, cfg):
    return np.stack([float_ref.mfcc_float(s, cfg) for s in sig])


def _plain(sig, cfg=MFCCConfig(), **kw):
    return fladder.mfcc_float_ladder_plain(torch.from_numpy(np.array(sig)),
                                           cfg, **kw).numpy()


def test_plain_matches_jax_k1_nfft512(cpu, sig2):
    with jax.default_device(cpu):
        want = np.asarray(pallas_fladder.mfcc_float_ladder_pallas(
            sig2, JaxConfig(), interpret=True))
    got = _plain(sig2)
    assert got.shape == want.shape == (2, 5, 32)
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got - _oracle(sig2, MFCCConfig())).max() <= TOL


def test_plain_matches_jax_k1_nfft256(cpu):
    jcfg, cfg = JaxConfig(nfft=256, step=86), MFCCConfig(nfft=256, step=86)
    sig = _tonal(256 + 9 * 86)
    with jax.default_device(cpu):
        want = np.asarray(pallas_fladder.mfcc_float_ladder_pallas(
            sig, jcfg, interpret=True))
    got = _plain(sig, cfg)
    assert got.shape == want.shape == (2, 10, 32)
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got - _oracle(sig, cfg)).max() <= TOL


def test_plain_nfft1024_against_oracle():
    """nfft 1024 has no JAX K1 test; hold the port to the oracle."""
    cfg = MFCCConfig(nfft=1024, step=340)
    sig = _tonal(1024 + 7 * 340, S=3, seed=6)
    got = _plain(sig, cfg)
    assert got.shape == (3, 8, 32)
    assert np.abs(got - _oracle(sig, cfg)).max() <= TOL


def test_int16_and_f32_inputs_agree(sig2):
    """The same integers as int16 or f32 give the same bits."""
    assert np.array_equal(_plain(sig2.astype(np.int16)), _plain(sig2))
    got = fladder.mfcc_float_ladder(torch.from_numpy(sig2.astype(np.int16)))
    assert np.array_equal(got.numpy(), _plain(sig2))


def test_normalized_input_not_truncated(sig2):
    """[-1, 1] samples compute as floats (int16 truncation would zero
    them): the oracle on the same floats within TOL."""
    x = (sig2 / 32768.0).astype(np.float32)
    got = _plain(x)
    assert np.abs(got - _oracle(x.astype(np.float64), MFCCConfig())).max() \
        <= TOL
    got64 = _plain(x.astype(np.float64))
    assert np.abs(got64 - got).max() <= TOL


def test_mel_floor_on_silence_matches_jax(cpu, sig2):
    sig = np.concatenate([sig2[:1], np.zeros_like(sig2[:1])])
    with jax.default_device(cpu):
        want = np.asarray(pallas_fladder.mfcc_float_ladder_pallas(
            sig, JaxConfig(), interpret=True, mel_floor=1.0))
    got = _plain(sig, mel_floor=1.0)
    assert np.isfinite(got).all()
    assert np.abs(got[1]).max() == 0.0     # log2(max(0, 1)) = 0
    assert np.abs(got - want).max() <= TOL
    # without the floor, silence is -inf/NaN, as in the spec
    assert not np.isfinite(_plain(sig)[1]).any()


def test_leading_dims_and_1d(sig2):
    full = _plain(sig2)
    x3 = np.stack([sig2, sig2[::-1]])           # (2, 2, T)
    got = _plain(x3)
    assert got.shape == (2, 2) + full.shape[1:]
    assert np.array_equal(got[0], full)
    one = _plain(sig2[1])
    assert one.shape == full.shape[1:]
    assert np.array_equal(one, full[1])


def test_short_signal_raises():
    with pytest.raises(ValueError, match="shorter than one frame"):
        _plain(np.zeros((1, 400), np.float32))


GRID = list(itertools.product(
    (128, 256, 512, 1024, 2048),                 # nfft
    (None, 85, 86, 160, 170, 171),               # step
    (None, 200),                                 # window_samples
    ((16000, 32), (8000, 32), (16000, 40), (16000, 64))))   # (sr, ntap)


def test_config_ok_matches_jax():
    n = 0
    for nfft, step, ws, (sr, ntap) in GRID:
        if step is not None and step > (ws or nfft):
            continue
        kw = dict(nfft=nfft, step=step, window_samples=ws, samplerate=sr,
                  nfilters=ntap)
        assert (fladder.fladder_config_ok(MFCCConfig(**kw))
                == pallas_fladder.pallas_fladder_config_ok(JaxConfig(**kw))), kw
        n += 1
    assert n > 200


def test_operators_natural_order():
    cfg = MFCCConfig()
    win, mel, dct = fladder.fladder_operators(cfg)
    from mfcc_tpu import tables as jt
    assert np.array_equal(win, jt.float_window(512) / 512)
    assert np.array_equal(mel, jt.float_mel_matrix(16000, 512, 32)[:256])
    assert np.array_equal(dct, jt.dct2_ortho_matrix(32))
    assert win.dtype == mel.dtype == dct.dtype == np.float64
    tw = fladder.twiddles(8, torch.device("cpu")).numpy()
    np.testing.assert_allclose(tw[:, 0] + 1j * tw[:, 1],
                               np.exp(-2j * np.pi * np.arange(4) / 8),
                               atol=1e-15)


def test_mel_bands_cover_every_nonzero():
    for nfft in (256, 512, 1024):
        _, mel, _ = fladder.fladder_operators(MFCCConfig(nfft=nfft))
        band = fladder.mel_bands(torch.from_numpy(mel)).numpy()
        assert band.dtype == np.int32 and band.shape == (32, 2)
        for m in range(32):
            nz = np.nonzero(mel[:, m])[0]
            assert band[m, 0] == nz.min() and band[m, 1] == nz.max() + 1
            assert not mel[: band[m, 0], m].any()
            assert not mel[band[m, 1]:, m].any()
    zero = torch.zeros(8, 3, dtype=torch.float64)
    zero[2:5, 1] = 1.0
    assert fladder.mel_bands(zero).tolist() == [[0, 8], [2, 5], [0, 8]]


def test_wrapper_cpu_takes_plain_and_counts_nothing(sig2):
    before = fladder.LAUNCHES
    got = fladder.mfcc_float_ladder(torch.from_numpy(sig2), mel_floor=0.0)
    assert fladder.LAUNCHES == before
    assert np.array_equal(got.numpy(), _plain(sig2))


def test_wrapper_rejects_configs_outside_family(sig2):
    for cfg in (MFCCConfig(step=171), MFCCConfig(nfft=2048),
                MFCCConfig(step=160, window_samples=400)):
        with pytest.raises(ValueError, match="outside K1's family"):
            fladder.mfcc_float_ladder(torch.from_numpy(sig2), cfg)


# The entries on the FP64 tail's walk: (entry, its ingest, a config in its
# family, one outside it, whether it takes frames).
WALK_ENTRIES = {
    "K1": (fladder.mfcc_float_ladder, fladder.FPGA, MFCCConfig(),
           MFCCConfig(window_samples=400), False),
    "K6": (float_fused.mfcc_recomp_t, fladder.FPGA, MFCCConfig(step=171),
           MFCCConfig(step=160, window_samples=400), False),
    "K1-Kaldi": (fladder.mfcc_kaldi_ladder, fladder.KALDI, KALDI_MFCC_HIRES,
                 MFCCConfig(), False),
    "K1-Kaldi frames": (fladder.mfcc_kaldi_frames, fladder.KALDI,
                        KALDI_MFCC_HIRES, MFCCConfig(), True),
    "K7": (f64ish.mfcc_f64ish, fladder.F64ISH, MFCCConfig(),
           MFCCConfig(window_samples=400), False),
    "K7-frames": (f64ish.mfcc_f64ish_frames, fladder.F64ISH_FRAMES,
                  MFCCConfig(), MFCCConfig(window_samples=400), True),
}


@pytest.mark.parametrize("name", sorted(WALK_ENTRIES))
def test_walk_entries_check_through_the_shared_launcher(name, monkeypatch):
    """Each entry on the walk keeps its own family error and its frames'
    shape error (audio: a signal shorter than one frame) before any
    launch, and reaches ``launch_tail`` with its ingest, whose device
    check names the entry; no counter moves on the way."""
    fn, ingest, cfg, outside, takes_frames = WALK_ENTRIES[name]
    meta = torch.zeros((2, 3, 512) if takes_frames else (2, 2000),
                       device="meta")
    counts = (fladder.LAUNCHES, fladder.KALDI_LAUNCHES,
              fladder.MEL_SCHEDULE_LAUNCHES, dict(f64ish.LAUNCHES),
              dict(float_fused.LAUNCHES))
    seen = []
    launch = fladder.launch_tail

    def spy(ing, *args, **kwargs):
        seen.append(ing)
        return launch(ing, *args, **kwargs)

    monkeypatch.setattr(fladder, "launch_tail", spy)
    with pytest.raises(ValueError, match="family"):
        fn(meta, outside)
    short, shape_error = ((torch.zeros(2, 3, 500, device="meta"), "frames")
                          if takes_frames else
                          (torch.zeros(2, 300, device="meta"),
                           "shorter than one frame"))
    with pytest.raises(ValueError, match=shape_error):
        fn(short, cfg)
    assert seen == []
    with pytest.raises(ValueError, match=f"^{name} runs on CUDA or CPU "
                                         "tensors, got meta"):
        fn(meta, cfg)
    assert seen == [ingest]
    assert counts == (fladder.LAUNCHES, fladder.KALDI_LAUNCHES,
                      fladder.MEL_SCHEDULE_LAUNCHES, dict(f64ish.LAUNCHES),
                      dict(float_fused.LAUNCHES))
