"""The torch package's config, tables and float64 oracle against the JAX
package's: the numpy pieces are copies, so every array must be equal bit
for bit (``np.array_equal``, no tolerance)."""

import dataclasses

import numpy as np
import pytest

import mfcc_tpu
from mfcc_tpu import tables as jtables
from mfcc_tpu.ref import float_ref as jref

import mfcc_tpu_torch
from mfcc_tpu_torch import config as tconfig, tables as ttables
from mfcc_tpu_torch.ref import float_ref as tref

JAX_CONFIGS = {
    "default": mfcc_tpu.DEFAULT_CONFIG,
    "mic": mfcc_tpu.MIC_CONFIG,
    "nfft256": mfcc_tpu.MFCCConfig(nfft=256, step=86),
    "nfft1024": mfcc_tpu.MFCCConfig(nfft=1024, step=340),
}


@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_from_jax_round_trips(name):
    jcfg = JAX_CONFIGS[name]
    cfg = tconfig.from_jax(jcfg)
    assert type(cfg) is mfcc_tpu_torch.MFCCConfig
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for prop in ("hop", "windowlen", "nbins", "nbins_float", "log_precision",
                 "filter_wsize"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    for n in (0, 511, 512, 513, 16000, 63_922):
        assert cfg.n_frames(n) == jcfg.n_frames(n)


def test_default_configs_match():
    assert (dataclasses.asdict(mfcc_tpu_torch.DEFAULT_CONFIG)
            == dataclasses.asdict(mfcc_tpu.DEFAULT_CONFIG))
    assert (dataclasses.asdict(mfcc_tpu_torch.MIC_CONFIG)
            == dataclasses.asdict(mfcc_tpu.MIC_CONFIG))
    with pytest.raises(ValueError, match="step=600"):
        mfcc_tpu_torch.MFCCConfig(step=600)


@pytest.mark.parametrize("nfft", [256, 512, 1024])
def test_tables_equal(nfft):
    assert np.array_equal(ttables.float_window(nfft),
                          jtables.float_window(nfft))
    for sr, ntap in ((16000, 32), (8000, 24), (16000, 40)):
        assert np.array_equal(ttables.mel_filter_points(sr, nfft, ntap),
                              jtables.mel_filter_points(sr, nfft, ntap))
        assert np.array_equal(ttables.float_mel_matrix(sr, nfft, ntap),
                              jtables.float_mel_matrix(sr, nfft, ntap))
    for got, want in zip(ttables.windowed_rdft_matrix(nfft),
                         jtables.windowed_rdft_matrix(nfft)):
        assert np.array_equal(got, want)
    for got, want in zip(ttables.windowed_rdft_matrix(nfft, scale=1.0),
                         jtables.windowed_rdft_matrix(nfft, scale=1.0)):
        assert np.array_equal(got, want)


def test_mel_conversions_and_dct_equal():
    f = np.linspace(0.0, 8000.0, 101)
    assert np.array_equal(ttables.freq_to_mel(f), jtables.freq_to_mel(f))
    m = ttables.freq_to_mel(f)
    assert np.array_equal(ttables.mel_to_freq(m), jtables.mel_to_freq(m))
    for n in (16, 24, 32, 40):
        assert np.array_equal(ttables.dct2_ortho_matrix(n),
                              jtables.dct2_ortho_matrix(n))


def test_windowed_rdft_given_window():
    """An explicit window equal to the default gives the same operator."""
    w = jtables.float_window(512)
    for got, want in zip(ttables.windowed_rdft_matrix(512, window=w),
                         jtables.windowed_rdft_matrix(512)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_float_ref_equal(audio_int16, name):
    jcfg = JAX_CONFIGS[name]
    sig = np.concatenate([audio_int16, audio_int16[::-1]])   # >= 1 frame at 1024
    got, gi = tref.mfcc_float(sig, tconfig.from_jax(jcfg),
                              return_intermediates=True)
    want, wi = jref.mfcc_float(sig, jcfg, return_intermediates=True)
    assert np.array_equal(got, want)
    assert gi.keys() == wi.keys()
    for k in gi:
        assert np.array_equal(gi[k], wi[k]), k
    assert np.array_equal(tref.lifter(got), jref.lifter(want))
