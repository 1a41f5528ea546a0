"""The torch package's remaining INT entries (``ops/int_fused.py``) on the
CPU, through their plain versions: K9 (``mfcc_int_v2``) and K3-v1
(``mfcc_int_v1``) element for element against the JAX package's
``mfcc_int_pallas_v2`` and ``mfcc_int_pallas`` run in interpret mode, and
K10 (``mfcc_int_split2``) against K2's plain version; all against the RTL
oracle ``int_ref.mfcc_int``.  K3-v1's kernel path is modelled too: K2's
ingest at int32 (``warp_tails.int_audio_ingest_model``) through the warp
schedule, on a stream of int32 edges where every emphasis wraps; the
balanced filterbank of K3 and K10's epilogue, against JAX K3
(``mfcc_int_pallas_frames``) and the oracle, on power rows at the top of
their range and on ragged row counts of the epilogue's walk; and the same
filterbank behind K2's ingest (K2, K9 and K3-v1) against the oracle.

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


# -- the balanced filterbank of K3 and K10's epilogue ---------------------------

FB_CFGS = {32: (MFCCConfig(), JaxConfig()),
           16: (MFCCConfig(nfilters=16, nceptrums=16),
                JaxConfig(nfilters=16, nceptrums=16))}


def _oracle_from_power(power, jcfg):
    """``int_ref``'s stages after the power, its filterbank summed exactly
    (Python integers) before the shift."""
    mel = np.stack([int_ref.filterbank_int(
        p, jcfg.samplerate, jcfg.nfft, jcfg.nfilters, jcfg.filter_wsize,
        jcfg.filter_gain, width=jcfg.power_width) for p in power])
    logmel = int_ref.log2fix_int(mel, 16, jcfg.log_width_output)
    return int_ref.dct_int(logmel, jcfg.width)[:, : jcfg.nceptrums]


@pytest.mark.parametrize("nf", sorted(FB_CFGS))
def test_balanced_filterbank_matches_jax_k3_and_oracle(interpret, nf):
    """K3's path on the balanced filterbank, modelled with the kernel's
    index formulas (``int_tail_model(..., balanced=True)``), equals JAX K3
    (``mfcc_int_pallas_frames``, interpret mode), ``int_ref.mfcc_int`` and
    ``int_ops.mfcc_int_from_power`` element for element on the mixed
    stream's 60 frames (int16-range, then full-range int32 samples), at
    16 and 32 filters."""
    cfg, jcfg = FB_CFGS[nf]
    x, _ = _mixed()
    frames = framing.extract_frames(framing.preemphasis_int(
        torch.from_numpy(x)), 512, cfg.hop)[0]
    got = wt.int_tail_model(frames, cfg, balanced=True)
    want = np.asarray(pallas_int.mfcc_int_pallas_frames(
        jnp.asarray(frames.numpy()), jcfg, interpret=True))
    assert got.shape == want.shape == (60, nf)
    assert np.array_equal(got.numpy(), want)
    ref = int_ref.mfcc_int(x[0].astype(np.int64), jcfg)
    assert np.array_equal(got.numpy(), ref)
    power = wt.int_ladder_power_model(int_ops.window_int(frames))
    assert torch.equal(got, int_ops.mfcc_int_from_power(power, cfg))


@pytest.mark.parametrize("nf", sorted(FB_CFGS))
def test_balanced_filterbank_at_the_top_of_the_power_range(nf):
    """Power rows at the top of their 30-bit range (every bin 2^30 - 1,
    bins drawn from [2^29, 2^30), one hot bin per row), where every
    product of the filterbank passes 2^32 and its sums wrap mod 2^64: the
    balanced model equals the lane-per-filter model, ``int_ops`` and the
    oracle's exact sums, and K10's epilogue (its plain version on the CPU)
    on them."""
    cfg, jcfg = FB_CFGS[nf]
    rng = np.random.default_rng(nf)
    top = 2 ** 30 - 1
    hot = np.zeros((4, 256), np.int64)
    hot[np.arange(4), rng.integers(0, 256, 4)] = top
    power = np.concatenate([np.full((2, 256), top),
                            rng.integers(2 ** 29, 2 ** 30, (6, 256)), hot,
                            np.zeros((1, 256), np.int64)]).astype(np.int32)
    p = torch.from_numpy(power)
    got = wt.int_post_power_model(p, cfg, balanced=True)
    assert torch.equal(got, wt.int_post_power_model(p, cfg))
    assert torch.equal(got, int_ops.mfcc_int_from_power(p, cfg))
    assert torch.equal(got, int_fused.mfcc_int_epi(p, cfg))
    assert np.array_equal(got.numpy(), _oracle_from_power(power, jcfg))


@pytest.mark.parametrize("M", [1, 5, 7, 9, 1700])
def test_epilogue_on_ragged_rows(M):
    """K10's epilogue on M power rows (M = 1, M < 8, M not a multiple of 8,
    M beyond the resident warps), as the kernel's walk and the balanced
    filterbank take them (``epilogue_walk`` on a grid of 3 blocks, each
    row through ``int_post_power_model(..., balanced=True)``), equals the
    epilogue's plain version, also with two leading axes."""
    cfg = MFCCConfig()
    rng = np.random.default_rng(M)
    p = torch.from_numpy(rng.integers(0, 2 ** 30, (M, 256)).astype(np.int32))
    want = int_fused.mfcc_int_epi_plain(p, cfg)
    rows = [row for *_, row in wt.epilogue_walk(M, 3)]
    assert sorted(rows) == list(range(M))
    got = torch.empty_like(want)
    got[rows] = wt.int_post_power_model(p[rows], cfg, balanced=True)
    assert torch.equal(got, want)
    if M % 2 == 0 or M == 1:
        lead = p.reshape(1, M, 256) if M == 1 else p.reshape(2, M // 2, 256)
        assert torch.equal(int_fused.mfcc_int_epi(lead, cfg).reshape(M, -1),
                           want)


def _k2_inputs(hop):
    """(name, samples the kernel reads, the samples the oracle reads): two
    ragged streams of 7 frames each, tonal and full-range int16; int32
    outside the int16 range under K2's wire rule (taken mod 2^16, then
    the int16 ingest) and under K3-v1's (read whole, the int32 ingest)."""
    rng = np.random.default_rng(hop)
    T = 512 + 6 * hop + 37
    t = np.arange(T) / 16000.0
    tone = np.round(12000 * np.sin(2 * np.pi * (300 + 2500 * t) * t)
                    + rng.integers(-900, 900, (2, T))).astype(np.int16)
    full = rng.integers(-32768, 32768, (2, T)).astype(np.int16)
    wide = rng.integers(-2 ** 31, 2 ** 31, (2, T)).astype(np.int32)
    wrapped = framing.wrap_signed(torch.from_numpy(wide), 16).to(
        torch.int16).numpy()
    return [("tonal int16", tone, tone), ("full-range int16", full, full),
            ("int32, K2's rule", wrapped, wrapped),
            ("int32, K3-v1's rule", wide, wide)]


@pytest.mark.parametrize("hop", [170, 160])
@pytest.mark.parametrize("nf", sorted(FB_CFGS))
def test_k2_ingest_on_the_balanced_tail_is_the_oracle(nf, hop):
    """K2's, K9's and K3-v1's kernel path as it now runs, modelled with the
    kernel's index formulas: the audio ingest (``int_audio_ingest_model``:
    the first frame's prev 0, frames by address at the hop) feeding the
    ladder and power and the balanced filterbank
    (``int_post_power_model(..., balanced=True)``) equals the
    lane-per-filter model and ``int_ref.mfcc_int`` element for element,
    at 16 and 32 filters and hops 170 and 160, on tonal and full-range
    int16 and on int32 outside the int16 range under both wire rules."""
    cfg = MFCCConfig(nfilters=nf, nceptrums=nf, step=hop)
    for name, x, oracle_in in _k2_inputs(hop):
        xt = torch.from_numpy(x)
        regs = wt.int_audio_ingest_model(xt, cfg)
        power = wt.int_ladder_power_registers(regs)
        got = wt.int_post_power_model(power, cfg, balanced=True)
        assert torch.equal(got, wt.int_post_power_model(power, cfg)), name
        want = _oracle(oracle_in, cfg)
        assert want.shape == (2, 7, nf)
        assert np.array_equal(got.reshape(want.shape).numpy(), want), name
        plain = (int_fused.mfcc_int_v1_plain if x.dtype == np.int32
                 else int_fused.mfcc_int_fused_plain)
        assert np.array_equal(plain(xt, cfg).numpy(), want), name
