"""The torch package's INT tables, oracle, ``int_ops`` chain and fused-kernel
wrappers against the JAX package's on the CPU.  The INT contract is
element-exact: every comparison here is ``np.array_equal`` (tolerance 0).
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mfcc_tpu
from mfcc_tpu import tables as jtables
from mfcc_tpu.ops import framing as jframing, int_ops as jint, pallas_int
from mfcc_tpu.ref import int_ref as jref

from mfcc_tpu_torch import MFCCConfig, tables as ttables
from mfcc_tpu_torch.config import from_jax
from mfcc_tpu_torch.kernels import build
from mfcc_tpu_torch.ops import fladder, framing, int_fused, int_ops
from mfcc_tpu_torch.ref import int_ref as tref

CFG = MFCCConfig()
JAX_CONFIGS = {
    "default": mfcc_tpu.DEFAULT_CONFIG,
    "mic": mfcc_tpu.MIC_CONFIG,
    "nfilters16": mfcc_tpu.MFCCConfig(nfilters=16, nceptrums=16),
    "nfft256": mfcc_tpu.MFCCConfig(nfft=256, step=86),
}


def _signals(audio_int16):
    """(name, (n,) int64 signal): the rich fixture, full-range adversarial
    int16 (the wrap paths), silence (the log2 clamp), constant -32768 and
    alternating +-32767."""
    n = 512 + 4 * 170
    rng = np.random.default_rng(99)
    return {
        "tonal": audio_int16.astype(np.int64),
        "full_range": rng.integers(-32768, 32768, n).astype(np.int64),
        "silence": np.zeros(n, np.int64),
        "min_const": np.full(n, -32768, np.int64),
        "alternating": np.tile(np.array([32767, -32767], np.int64), n // 2),
    }


SIGNALS = ["tonal", "full_range", "silence", "min_const", "alternating"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_int_tables_equal(name):
    cfg = JAX_CONFIGS[name]
    nfft, ntap = cfg.nfft, cfg.nfilters
    for size in (nfft, 4 * ntap):
        assert np.array_equal(ttables.bit_reverse_permutation(size),
                              jtables.bit_reverse_permutation(size))
        for got, want in zip(ttables.twiddle_table(size, cfg.width),
                             jtables.twiddle_table(size, cfg.width)):
            assert np.array_equal(got, want)
        for got, want in zip(ttables.dit_stage_plan(size),
                             jtables.dit_stage_plan(size)):
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
    got, want = (ttables.hamming_lut(nfft, cfg.window_precision),
                 jtables.hamming_lut(nfft, cfg.window_precision))
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    assert np.array_equal(ttables.int_window_curve(nfft, cfg.window_precision),
                          jtables.int_window_curve(nfft, cfg.window_precision))
    wsize = cfg.filter_wsize
    points = jtables.mel_filter_points(cfg.samplerate, nfft, ntap)
    assert np.array_equal(ttables.mel_filter_steps(points, wsize),
                          jtables.mel_filter_steps(points, wsize))
    for got, want in zip(
            ttables.int_filterbank_schedule(cfg.samplerate, nfft, ntap, wsize),
            jtables.int_filterbank_schedule(cfg.samplerate, nfft, ntap, wsize)):
        assert np.array_equal(got, want)
    assert np.array_equal(
        ttables.int_filterbank_matrix(cfg.samplerate, nfft, ntap, wsize),
        jtables.int_filterbank_matrix(cfg.samplerate, nfft, ntap, wsize))
    for got, want in zip(ttables.dct_fill_layout(ntap),
                         jtables.dct_fill_layout(ntap)):
        assert np.array_equal(got, want)
    key = (cfg.samplerate, nfft, ntap, wsize, cfg.filter_gain, 16,
           cfg.power_width)
    (gw, gs), (ww, ws) = int_ops._fb_constants(*key), jint._fb_constants(*key)
    assert np.array_equal(gw, ww) and gs == ws
    tcfg = from_jax(cfg)
    assert int_ops._fb_int32_layout_ok(tcfg) == jint._fb_int32_layout_ok(cfg)


@pytest.mark.parametrize("name", SIGNALS)
def test_int_ref_equal(audio_int16, name):
    sig = _signals(audio_int16)[name]
    got, gi = tref.mfcc_int(sig, CFG, return_intermediates=True)
    want, wi = jref.mfcc_int(sig, mfcc_tpu.MFCCConfig(),
                             return_intermediates=True)
    assert np.array_equal(got, want)
    assert gi.keys() == wi.keys()
    for k in gi:
        assert np.array_equal(gi[k], wi[k]), k
    # the sequential FilterBank datapath and the closed form agree
    p = gi["power"][0]
    assert np.array_equal(tref.filterbank_int_sequential(p),
                          jref.filterbank_int_sequential(p))
    assert np.array_equal(tref.filterbank_int_sequential(p), gi["mel"][0])


@pytest.mark.parametrize("name", SIGNALS)
def test_stages_exact(audio_int16, name):
    """Each ``int_ops`` stage against ``mfcc_tpu.ops.int_ops`` and the
    oracle, on the stage's oracle input."""
    sig = _signals(audio_int16)[name]
    _, st = jref.mfcc_int(sig, mfcc_tpu.MFCCConfig(),
                          return_intermediates=True)
    with jax.enable_x64():
        def j(fn, *args):
            return np.asarray(fn(*(jnp.asarray(a, jnp.int32) for a in args)))

        emph = framing.preemphasis_int(_t(sig).to(torch.int32)).numpy()
        assert np.array_equal(emph, st["emph"])
        assert np.array_equal(emph, j(jframing.preemphasis_int, sig))
        frames = framing.extract_frames(_t(emph), 512, 170).numpy()
        assert np.array_equal(frames, st["frames"])
        win = int_ops.window_int(_t(frames)).numpy()
        assert np.array_equal(win, st["win"])
        assert np.array_equal(win, j(jint.window_int, frames))
        re_, im_ = (a.numpy() for a in int_ops.fft_stream_int(_t(win)))
        assert np.array_equal(re_, st["fft_re"])
        assert np.array_equal(im_, st["fft_im"])
        jre, jim = jint.fft_stream_int(jnp.asarray(win, jnp.int32))
        assert np.array_equal(re_, jre) and np.array_equal(im_, jim)
        power = int_ops.power_int(_t(re_), _t(im_)).numpy()
        assert np.array_equal(power, st["power"])
        assert np.array_equal(power, j(jint.power_int, re_, im_))
        mel = int_ops.filterbank_int(_t(power)).numpy()
        assert np.array_equal(mel, st["mel"])
        assert np.array_equal(mel, j(jint.filterbank_int, power))
        logmel = int_ops.log2fix_int(_t(mel)).numpy()
        assert np.array_equal(logmel, st["logmel"])
        assert np.array_equal(logmel, j(jint.log2fix_int, mel))
        cep = int_ops.dct_int(_t(logmel)).numpy()
        assert np.array_equal(cep, st["cep"])
        assert np.array_equal(cep, j(jint.dct_int, logmel))
    for a in (emph, win, re_, power, mel, logmel, cep):
        assert a.dtype == np.int32


def test_power_is_a_logical_shift():
    """r = i = -32768 gives r*r + i*i = 2^31, negative in int32: the
    logical shift must give 2^29, not a negative number."""
    r = torch.tensor([-32768, 32767, -1, 0], dtype=torch.int32)
    got = int_ops.power_int(r, r).numpy()
    want = jref.power_int(r.numpy(), r.numpy())
    assert np.array_equal(got, want)
    assert got[0] == 1 << 29


def test_wrap_signed_and_preemphasis_carry():
    rng = np.random.default_rng(5)
    v = rng.integers(-2 ** 31, 2 ** 31, 1000).astype(np.int32)
    for bits in (8, 15, 16):
        assert np.array_equal(framing.wrap_signed(_t(v), bits).numpy(),
                              np.asarray(jframing.wrap_signed(
                                  jnp.asarray(v), bits)))
    x = rng.integers(-32768, 32768, (3, 50)).astype(np.int32)
    carry = np.array([32767, -32768, 5], np.int32)
    got = framing.preemphasis_int(_t(x), _t(carry)).numpy()
    want = np.asarray(jframing.preemphasis_int(jnp.asarray(x),
                                               jnp.asarray(carry)))
    assert np.array_equal(got, want)


def test_filterbank_chunks_agree(monkeypatch):
    """The chunked int64 product gives the unchunked result, including a
    ragged last chunk, and the sum wraps mod 2^64 as the JAX int64 one."""
    rng = np.random.default_rng(6)
    power = rng.integers(0, 1 << 30, (2, 7, 256)).astype(np.int32)
    whole = int_ops.filterbank_int(_t(power)).numpy()
    monkeypatch.setattr(int_ops, "FB_CHUNK", 3)
    assert np.array_equal(int_ops.filterbank_int(_t(power)).numpy(), whole)
    with jax.enable_x64():
        want = np.asarray(jint.filterbank_int(jnp.asarray(power)))
    assert np.array_equal(whole, want)
    assert whole.shape == (2, 7, 32)


def test_log2fix_known_values():
    out = int_ops.log2fix_int(torch.tensor([1, 2, 4, 1024, 32768, 0, 3]))
    assert out.tolist()[:6] == [0, 1 << 11, 2 << 11, 10 << 11, 15 << 11, 0]
    assert out[6] % 2 == 0 and abs(int(out[6]) - 1.584962 * 2048) < 4


@pytest.mark.parametrize("kw", [
    {}, dict(nceptrums=16), dict(nfilters=16, nceptrums=16), dict(step=160),
    dict(width=15), dict(step=171), dict(step=160, window_samples=400),
])
def test_chain_configs_match_oracle(audio_int16, kw):
    """The chain on the configs the module routes to it (and on the
    kernels' family) against the oracle and ``mfcc_tpu`` int_ops."""
    cfg = MFCCConfig(**kw)
    sig = audio_int16.astype(np.int64)
    if cfg.width < 16:
        sig = sig >> (16 - cfg.width)
    got = int_ops.mfcc_int_batch(_t(sig[None]), cfg).numpy()[0]
    assert np.array_equal(got, tref.mfcc_int(sig, cfg))
    with jax.enable_x64():
        want = np.asarray(jint.mfcc_int_batch(jnp.asarray(sig[None], jnp.int32),
                                              mfcc_tpu.MFCCConfig(**kw)))[0]
    assert np.array_equal(got, want)


def test_int_config_ok_matches_jax():
    grid = [dict(nfft=n, step=h, nfilters=f, width=w, window_samples=ws,
                 nceptrums=min(32, f))
            for n in (256, 512, 1024) for h in (160, 170, 171)
            for f in (16, 24, 32) for w in (15, 16) for ws in (None, 400)
            if h <= (ws or n)]
    grid += [dict(window_precision=7), dict(power_width=28),
             dict(filter_gain=17), dict(samplerate=8000)]
    assert len(grid) > 100
    for kw in grid:
        got = int_fused.int_config_ok(MFCCConfig(**kw))
        assert got == pallas_int.pallas_int_config_ok(
            mfcc_tpu.MFCCConfig(**kw)), kw
    assert int_fused.int_config_ok(CFG)
    assert not int_fused.int_config_ok(MFCCConfig(width=15))
    assert not int_fused.int_config_ok(MFCCConfig(step=171))


def test_fused_cpu_takes_plain_and_never_launches(audio_int16):
    x = _t(audio_int16.astype(np.int32)[None])
    frames = framing.extract_frames(framing.preemphasis_int(x), 512, 170)
    before = dict(int_fused.LAUNCHES)
    got = int_fused.mfcc_int_fused(x)
    got_f = int_fused.mfcc_int_fused_frames(frames.contiguous())
    assert int_fused.LAUNCHES == before
    assert torch.equal(got, int_fused.mfcc_int_fused_plain(x))
    assert torch.equal(got_f, got)
    assert np.array_equal(got.numpy()[0],
                          tref.mfcc_int(audio_int16.astype(np.int64)))


def test_fused_takes_samples_mod_2_16():
    """K2's int16 wire contract: out-of-range int32 samples are taken mod
    2^16 by the kernel's wrapper and its plain version alike."""
    rng = np.random.default_rng(7)
    x = rng.integers(-2 ** 31, 2 ** 31, (2, 900)).astype(np.int32)
    got = int_fused.mfcc_int_fused(_t(x)).numpy()
    w16 = x.astype(np.int16).astype(np.int64)
    assert np.array_equal(got, np.stack([tref.mfcc_int(s) for s in w16]))
    assert not np.array_equal(got, int_ops.mfcc_int_batch(_t(x)).numpy())


def test_fused_rejects_configs_outside_family():
    x = torch.zeros(1, 1000, dtype=torch.int32)
    with pytest.raises(ValueError, match="family"):
        int_fused.mfcc_int_fused(x, MFCCConfig(step=171))
    with pytest.raises(ValueError, match="family"):
        int_fused.mfcc_int_fused_frames(torch.zeros(1, 512, dtype=torch.int32),
                                        MFCCConfig(width=15))


@pytest.mark.parametrize("nfilters", [16, 32])
def test_operators_and_bands(nfilters):
    """The kernels' tables: the filterbank summed over each column's band
    equals the dense product; twiddles and curve are the RTL's."""
    cfg = MFCCConfig(nfilters=nfilters, nceptrums=nfilters)
    ops = int_fused.int_operators(cfg, torch.device("cpu"))
    assert int_fused.int_operators(cfg, torch.device("cpu")) is ops
    W = ops.fbw.numpy()
    for j, (lo, hi) in enumerate(ops.band.tolist()):
        assert not W[:lo, j].any() and not W[hi:, j].any()
        assert hi > lo
    # each bin feeds at most two filters
    assert ((W != 0).sum(axis=1) <= 2).all()
    assert ops.tw.shape == (256, 2) and ops.dtw.shape == (2 * nfilters, 2)
    assert np.array_equal(ops.dtw[:, 0].numpy(),
                          jtables.twiddle_table(4 * nfilters, 16)[0])
    assert np.array_equal(ops.curve.numpy(), jtables.int_window_curve(512, 8))
    assert ops.fb_shift == jint._fb_constants(16000, 512, nfilters, 30, 18,
                                              16, 30)[1]
    assert ops.curve.dtype == torch.int32 and ops.fbw.dtype == torch.int64
    # the band format is K1's: one helper for both kernels
    assert torch.equal(ops.band, fladder.mel_bands(ops.fbw))
    assert ops.band.dtype == torch.int32 and ops.band.is_contiguous()


def test_signatures_match_sources():
    """Every entry point declared for ctypes is an ``extern "C"`` function
    of csrc/ with as many parameters, and pointer/integer kinds agree."""
    found = {}
    for src in build.sources():
        text = Path(src).read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[m.group(1)] = [p.strip() for p in m.group(2).split(",")]
    assert set(build.SIGNATURES) == set(found)
    for name, args in build.SIGNATURES.items():
        params = found[name]
        assert len(args) == len(params), name
        for a, p in zip(args, params):
            if "*" in p:
                assert a is build._P, (name, p)
            elif p.startswith("long long"):
                assert a is build._LL, (name, p)
            elif p.startswith("int "):
                assert a is build._I, (name, p)
    assert any(p.name == "int_stages.cuh" for p in build.CSRC_DIR.iterdir())


@pytest.mark.parametrize("name", ["mfcc_int_i16", "mfcc_int_i32"])
def test_audio_entries_take_the_schedule(name):
    """K2's and K3-v1's C entries take the balanced filterbank's schedule
    where the filterbank matrix and its bands were: their tables are
    K3's (curve, tw, dtw, sched, then the stream), and the wrapper hands
    them ``IntOperators.fbs``, the same four pointers as K3's launch."""
    text = (build.CSRC_DIR / "int_mfcc.cu").read_text()
    params = {m.group(1): [p.strip().split()[-1].lstrip("*")
                           for p in m.group(2).split(",")]
              for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text)}
    assert params[name][-5:] == ["curve", "tw", "dtw", "sched", "stream"]
    assert params[name][-5:] == params["mfcc_int_frames_i32"][-5:]
    assert "fbw" not in params[name] and "band" not in params[name]
    args = build.SIGNATURES[name]
    assert args == build._INT_AUDIO_ARGS and len(args) == len(params[name])
    assert args[-5:] == [build._P] * 5
    assert args[-5:] == build.SIGNATURES["mfcc_int_frames_i32"][-5:]
    ops = int_fused.int_operators(MFCCConfig(), torch.device("cpu"))
    assert int_fused.table_ptrs(ops) == (
        ops.curve.data_ptr(), ops.tw.data_ptr(), ops.dtw.data_ptr(),
        ops.fbs.data_ptr())


def test_config_int_properties_match_jax():
    for name, jcfg in JAX_CONFIGS.items():
        cfg = from_jax(jcfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.log_precision == jcfg.log_precision == 11
    with pytest.raises(ValueError, match="width=17"):
        int_ops.mfcc_int_frames(torch.zeros(1, 512, dtype=torch.int32),
                                MFCCConfig(width=17))


LOG2CALC_INPUTS = np.array([1, 2, 3, 100, 1024, 2047, 2048, 2049, 4096,
                            123456, (1 << 26) | 12345, (1 << 27) - 1],
                           np.int64)


@pytest.mark.parametrize("frac", [False, True], ids=["plain", "fraction"])
def test_log2fixcalc_matches_fsm_and_jax(frac):
    """``log2fixcalc_int`` (the raw Log2FixCalc FSM's branch-free twin,
    fraction-input mode included) equals the literal FSM simulation and
    JAX's ``int_ops.log2fixcalc_int`` on the inputs of
    ``tests/test_config_variants.py``, the wrap of the negative exponent
    (inputs below 2^precision in fraction mode) included."""
    width, precision = 27, 11
    want = np.array([tref.log2fixcalc_seq(int(v), width, precision,
                                          allow_fraction_input=frac)
                     for v in LOG2CALC_INPUTS])
    got = int_ops.log2fixcalc_int(torch.from_numpy(LOG2CALC_INPUTS),
                                  width, precision,
                                  allow_fraction_input=frac)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    jgot = np.asarray(jint.log2fixcalc_int(
        jnp.asarray(LOG2CALC_INPUTS, jnp.int32), width, precision,
        allow_fraction_input=frac))
    assert np.array_equal(got.numpy(), jgot)
    if frac:    # below 2^precision: a negative exponent, wrapped to 27 bits
        assert (want[:6] > (1 << 26)).all()


def test_log2fixcalc_agrees_with_log2fix():
    """Fed ``data << precision`` (what Log2Fix does), the raw FSM's low 15
    bits are ``log2fix_int``'s output; precision > 14 is refused."""
    width, precision = 27, 11
    data = np.array([0, 1, 5, 77, 65535], np.int64)
    calc = int_ops.log2fixcalc_int(
        torch.from_numpy(np.maximum(data, 1) << precision), width, precision)
    fix = int_ops.log2fix_int(torch.from_numpy(data), 16, 15)
    assert torch.equal(calc & 0x7FFF, fix)
    assert np.array_equal(fix.numpy(), tref.log2fix_int(data, 16, 15))
    with pytest.raises(AssertionError, match="int32"):
        int_ops.log2fixcalc_int(torch.ones(3, dtype=torch.int32), 31, 15)
