"""The torch package's remaining INT entries (``ops/int_fused.py``) on the
CPU, through their plain versions: K9 (``mfcc_int_v2``) and K3-v1
(``mfcc_int_v1``) element for element against the JAX package's
``mfcc_int_pallas_v2`` and ``mfcc_int_pallas`` run in interpret mode, and
K10 (``mfcc_int_split2``) against K2's plain version; all against the RTL
oracle ``int_ref.mfcc_int``.  K3-v1's kernel path is modelled too: K2's
ingest at int32 (``warp_tails.int_audio_ingest_model``) through the warp
schedule, on a stream of int32 edges where every emphasis wraps.

The JAX kernels take no ``interpret`` argument, so the ``interpret``
fixture swaps ``pl.pallas_call`` for one that forces ``interpret=True``
for the test's duration; the JAX package is not edited.

The wire rules differ by entry, as in JAX: v2 (like K2 and K10) takes the
samples mod 2^16, v1 emphasizes int32 samples as they are and wraps only
the emphasis output.  On int32 input outside the int16 range v1 therefore
equals ``int_ref`` and v2 does not.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

from mfcc_tpu.config import MFCCConfig as JaxConfig
from mfcc_tpu.ops import pallas_int
from mfcc_tpu.ref import int_ref

from mfcc_tpu_torch import MFCCConfig, MIC_CONFIG
from mfcc_tpu_torch.ops import framing, int_fused, int_ops
from mfcc_tpu_torch.ops import warp_tails as wt


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pl.pallas_call`` of the test runs in interpret mode."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


@functools.lru_cache(maxsize=None)
def _mixed():
    """One stream of 60 frames (one JAX block): int16-range noise for its
    first 5000 samples, full-range int32 after; and the oracle on it."""
    rng = np.random.default_rng(0)
    T = 512 + 59 * 170
    x = rng.integers(-2 ** 31, 2 ** 31, (1, T)).astype(np.int32)
    x[0, :5000] = np.clip(rng.normal(0, 3000, 5000), -32768, 32767)
    ref = int_ref.mfcc_int(x[0].astype(np.int64), JaxConfig())[None]
    return x, ref


INT32_EDGES = (2 ** 31 - 1, -(2 ** 31 - 1), -2 ** 31)


@functools.lru_cache(maxsize=None)
def _edges():
    """One stream as long as ``_mixed``'s whose samples are the int32 edges
    +-(2^31 - 1) and -2^31 (t = 0 among them) or, one in four, any int32:
    every emphasis x + (prev >> 5) - prev wraps mod 2^32.  And the oracle
    on it."""
    rng = np.random.default_rng(3)
    T = _mixed()[0].shape[1]
    x = np.array(INT32_EDGES, np.int64)[rng.integers(0, 3, T)]
    wild = rng.random(T) < 0.25
    x[wild] = rng.integers(-2 ** 31, 2 ** 31, int(wild.sum()))
    x[:3] = INT32_EDGES
    x = x.astype(np.int32)[None]
    return x, int_ref.mfcc_int(x[0].astype(np.int64), JaxConfig())[None]


@functools.lru_cache(maxsize=None)
def _jax_v1(stream):
    """JAX v1 (``mfcc_int_pallas``) on ``_mixed`` or ``_edges``, computed
    once; call it under the ``interpret`` fixture."""
    x, _ = {"mixed": _mixed, "edges": _edges}[stream]()
    return np.asarray(pallas_int.mfcc_int_pallas(jnp.asarray(x), JaxConfig()))


def _oracle(x, cfg):
    jc = JaxConfig(nfft=cfg.nfft, step=cfg.step, nfilters=cfg.nfilters,
                   nceptrums=cfg.nceptrums, samplerate=cfg.samplerate)
    return np.stack([int_ref.mfcc_int(s.astype(np.int64), jc) for s in x])


def test_v1_matches_jax_and_the_oracle(interpret):
    """K3-v1's plain version equals JAX v1 and ``int_ref`` element for
    element, on int16-range and full-range int32 samples alike; the CPU
    wrapper takes the plain version without a launch."""
    x, ref = _mixed()
    want = _jax_v1("mixed")
    got = int_fused.mfcc_int_v1_plain(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == ref.shape
    assert np.array_equal(got, want)
    assert np.array_equal(got, ref)
    before = dict(int_fused.LAUNCHES)
    assert np.array_equal(int_fused.mfcc_int_v1(torch.from_numpy(x)).numpy(),
                          got)
    assert int_fused.LAUNCHES == before


@pytest.mark.parametrize("stream", ["mixed", "edges", "int16"])
def test_int_audio_ingest_model_is_the_framed_chain(stream):
    """K2's and K3-v1's ingest, modelled with the kernel's index formulas
    (``warp_tails.int_audio_ingest_model``: lane, register, sample, prev,
    ``preemph32`` on int32 and ``preemph`` on int16, the window), equals the
    ``int_ops`` chain's framed, emphasized and windowed samples in the
    ladder's first layout: on int32 samples with the emphasis wrapping
    mod 2^32, and on int16 samples."""
    x = {"mixed": lambda: _mixed()[0], "edges": lambda: _edges()[0],
         "int16": lambda: _mixed()[0][:, :5000].astype(np.int16)}[stream]()
    xt = torch.from_numpy(x)
    got = wt.int_audio_ingest_model(xt)
    frames = framing.extract_frames(framing.preemphasis_int(
        xt.to(torch.int32)), 512, 170)
    want = wt.int_first_layout(int_ops.window_int(frames).reshape(-1, 512))
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


def test_v1_kernel_schedule_matches_jax_and_the_oracle(interpret):
    """K3-v1's whole path through the kernel's schedule: the modelled
    int32 ingest, then the ladder and power (``int_ladder_power_registers``)
    and the post-power stages (``int_post_power_model``) equal JAX v1 in
    interpret mode and ``int_ref`` element for element, on the mixed
    stream and on the stream of int32 edges, where K2's wire rule
    differs; the plain version agrees."""
    cfg = MFCCConfig()
    for stream, (x, ref) in (("mixed", _mixed()), ("edges", _edges())):
        xt = torch.from_numpy(x)
        regs = wt.int_audio_ingest_model(xt, cfg)
        got = wt.int_post_power_model(wt.int_ladder_power_registers(regs),
                                      cfg).reshape(ref.shape).numpy()
        assert np.array_equal(got, _jax_v1(stream)), stream
        assert np.array_equal(got, ref), stream
        assert np.array_equal(got, int_fused.mfcc_int_v1_plain(xt).numpy())
        assert (got != int_fused.mfcc_int_fused_plain(xt).numpy()).any()


def test_v2_matches_jax_under_the_wire_rule(interpret):
    """K9's plain version equals JAX v2 and K2's plain version element for
    element; both take the samples mod 2^16, so they equal ``int_ref`` on
    the wrapped samples and differ from it on the raw int32 ones."""
    x, ref = _mixed()
    want = np.asarray(pallas_int.mfcc_int_pallas_v2(jnp.asarray(x),
                                                    JaxConfig()))
    xt = torch.from_numpy(x)
    got = int_fused.mfcc_int_v2(xt).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, int_fused.mfcc_int_fused_plain(xt).numpy())
    wrapped = framing.wrap_signed(xt, 16).numpy()
    assert np.array_equal(got, _oracle(wrapped, MFCCConfig()))
    assert (got != ref).any()


@pytest.mark.parametrize("cfg", [MFCCConfig(), MIC_CONFIG,
                                 MFCCConfig(nfilters=16, nceptrums=16),
                                 MFCCConfig(step=160)],
                         ids=["default", "mic", "nfilters16", "hop160"])
def test_split2_is_k2(cfg):
    """K10's plain versions (front, then epilogue) compute K2's function:
    equal to K2's plain version and to ``int_ref`` on int16 input, and to
    K2's plain version on int32 input outside the int16 range."""
    rng = np.random.default_rng(1)
    x16 = np.clip(rng.normal(0, 4000, (2, 4000)), -32768, 32767).astype(
        np.int16)
    wide = rng.integers(-2 ** 31, 2 ** 31, (2, 3000)).astype(np.int32)
    for x in (x16, wide):
        xt = torch.from_numpy(x)
        got = int_fused.mfcc_int_split2(xt, cfg)
        assert torch.equal(got, int_fused.mfcc_int_split2_plain(xt, cfg))
        assert torch.equal(got, int_fused.mfcc_int_fused_plain(xt, cfg))
    assert np.array_equal(int_fused.mfcc_int_split2(torch.from_numpy(x16),
                                                    cfg).numpy(),
                          _oracle(x16, cfg))


def test_jax_split2_tool_is_stale_port_follows_k2(interpret, monkeypatch):
    """The JAX two-kernel arm (``tools/ab_int_r5.split2_build``) runs its
    ladder in the "evenodd" layout while ``_fb_limb_matrix`` orders the
    filterbank rows by ``_regroup_perm`` (``pallas_int.py:249-250``), so
    its epilogue reads the power rows out of order and misses ``int_ref``
    almost everywhere.  The port's K10 is held to K2's function and the
    oracle instead."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent
                                    / "tools"))
    import ab_int_r5
    x, _ = _mixed()
    x16 = np.tile(x[:, :5000], (1, 3))[:, : x.shape[1]].astype(np.int16)
    ref16 = int_ref.mfcc_int(x16[0].astype(np.int64), JaxConfig())[None]
    tool = np.asarray(ab_int_r5.split2_build(JaxConfig())(jnp.asarray(x16)))
    assert tool.shape == ref16.shape
    assert (tool != ref16).mean() > 0.9
    got = int_fused.mfcc_int_split2(torch.from_numpy(x16)).numpy()
    assert np.array_equal(got, ref16)


def test_split2_front_is_the_power_spectrum():
    """K10's first launch returns the power rows in natural bin order, the
    ``int_ops`` stages up to the power; its second launch is the rest."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(-32768, 32768, (3, 2000)).astype(
        np.int16))
    cfg = MFCCConfig()
    power = int_fused.mfcc_int_front(x, cfg)
    assert power.shape == (3, cfg.n_frames(2000), 256)
    assert power.dtype == torch.int32
    frames = framing.extract_frames(framing.preemphasis_int(
        x.to(torch.int32)), 512, cfg.hop)
    win = int_ops.window_int(frames)
    re, im = int_ops.fft_stream_int(win)
    assert torch.equal(power, int_ops.power_int(re, im))
    assert (power >= 0).all()          # the logical shift keeps it unsigned
    assert torch.equal(int_fused.mfcc_int_epi(power, cfg),
                       int_fused.mfcc_int_fused_plain(x, cfg))


def test_int_entry_checks():
    """Configs outside the fused kernels' family raise in every entry; on
    the CPU no entry launches."""
    x = torch.zeros(2, 4000, dtype=torch.int16)
    bad = MFCCConfig(nfft=256, step=86)
    for fn in (int_fused.mfcc_int_v1, int_fused.mfcc_int_v2,
               int_fused.mfcc_int_split2, int_fused.mfcc_int_front):
        with pytest.raises(ValueError, match="family"):
            fn(x, bad)
    before = dict(int_fused.LAUNCHES)
    for fn in (int_fused.mfcc_int_v1, int_fused.mfcc_int_v2,
               int_fused.mfcc_int_split2):
        assert fn(x).shape == (2, MFCCConfig().n_frames(4000), 32)
    assert int_fused.LAUNCHES == before
