"""The torch package's f64ish dial (K7 and K7-frames, ``ops/f64ish.py``)
and its ``split`` / ``segmented`` chain on the CPU, through their plain
versions, against the JAX package's compensated chain ``df32``, its K7
kernel in interpret mode, its ``float_ops`` and the float64 oracle, on the
same numpy inputs (2 streams x ~7 frames).

Tolerances, each with its reason:

  * port vs JAX ``df32``: 2e-5 max-abs.  The port computes in float64 and
    rounds once; ``df32`` reaches ~1e-5 of the oracle in double-f32
    (measured 3.8e-6 to 7.6e-6 here);
  * the f64ish gate: max over elements of |got - oracle| / max(1e-5,
    2 ulp(oracle)) (``bench.f64ish_gate_err``), <= 0.5 for the port on
    int16-range input (measured 0.12 to 0.24) and <= 1.0 elsewhere;
  * ``split`` / ``segmented`` vs JAX: 5e-5, the f32 chain's port-vs-JAX
    bound (measured <= 1.9e-5); vs the oracle 5e-4, the float contract;
  * ``split_matmul`` vs float64: 2e-5 relative (``tests/test_pallas.py``);
  * the CPU chain, streamed vs batch: equal (the same f32 emphasis and
    the same float64 tail).
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mfcc_tpu.config import MFCCConfig as JaxConfig
from mfcc_tpu.ops import df32, framing as jframing, pallas_df32
from mfcc_tpu.ops import float_ops as jfloat_ops
from mfcc_tpu.ref import float_ref

from mfcc_tpu_torch import MFCC, MFCCConfig, StreamingMFCC
from mfcc_tpu_torch.ops import f64ish, fladder, float_ops, framing

TOL_DF32 = 2e-5
TOL_CHAIN = 5e-5
GATE = 5e-4
NFFTS = [(256, 86), (512, 170), (1024, 340)]


def _tonal(S, T, seed):
    """Integer-valued f32 samples: a chirp and a tone shared by the streams
    plus per-stream noise (the JAX bench's ``make_audio``)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000.0
    base = (9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
            + 4000 * np.sin(2 * np.pi * 900 * t))
    return np.round(np.clip(base[None] + rng.integers(-1500, 1500, (S, T)),
                            -32768, 32767)).astype(np.float32)


def _jcfg(cfg):
    return JaxConfig(nfft=cfg.nfft, step=cfg.step,
                     window_samples=cfg.window_samples,
                     nfilters=cfg.nfilters, nceptrums=cfg.nceptrums)


def _oracle(sig, cfg):
    return np.stack([float_ref.mfcc_float(s.astype(np.float64), _jcfg(cfg))
                     for s in sig])


def gate_units(got, want):
    """``bench.f64ish_gate_err``: inf unless finite, <= 1.0 passes."""
    tol = np.maximum(1e-5, 2 * np.abs(want) * np.finfo(np.float32).eps)
    err = float((np.abs(got - want) / tol).max())
    return err if np.isfinite(err) else float("inf")


@functools.lru_cache(maxsize=None)
def _df32_batch(cfg, wire_grid=True):
    return jax.jit(functools.partial(df32.mfcc_batch_f64ish, cfg=_jcfg(cfg),
                                     wire_grid=wire_grid))


def _jax_df32(sig, cfg, wire_grid=True):
    return np.asarray(_df32_batch(cfg, wire_grid)(jnp.asarray(sig)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _signal(nfft, hop, seed=None):
    return _tonal(2, nfft + 6 * hop, seed=nfft if seed is None else seed)


# -- the family --------------------------------------------------------------

def test_config_family():
    """nfft in {256, 512, 1024}, full windows, a zero Nyquist mel row; any
    hop (the kernel frames by address)."""
    for cfg in (MFCCConfig(), MFCCConfig(nfft=256, step=86),
                MFCCConfig(nfft=1024, step=340), MFCCConfig(step=171)):
        assert f64ish.f64ish_config_ok(cfg)
        assert pallas_df32.pallas_f64ish_config_ok(_jcfg(cfg))
    assert not f64ish.f64ish_config_ok(MFCCConfig(window_samples=400))
    assert not f64ish.f64ish_config_ok(MFCCConfig(nfft=2048, step=680))
    with pytest.raises(ValueError, match="family"):
        f64ish.mfcc_f64ish(torch.zeros(1, 4000),
                           MFCCConfig(window_samples=400))
    with pytest.raises(ValueError, match="frames"):
        f64ish.mfcc_f64ish_frames(torch.zeros(2, 500))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        f64ish.mfcc_f64ish(torch.zeros(1, 4000, device="meta"))
    assert f64ish.LAUNCHES == {"K7": 0, "K7-frames": 0}


# -- against JAX df32 and the oracle ---------------------------------------------

@pytest.mark.parametrize("nfft,hop", NFFTS)
def test_batch_frames_module_streaming_match_df32(nfft, hop):
    """int16-range input at each nfft: the port's batch, frames, module
    (forward and frames) and streaming (with a flush) all within 2e-5 of
    JAX ``df32.mfcc_batch_f64ish`` and 0.5 gate units of the oracle."""
    cfg = MFCCConfig(nfft=nfft, step=hop)
    sig = _signal(nfft, hop)
    jax_out = _jax_df32(sig, cfg)
    want = _oracle(sig, cfg)
    assert gate_units(jax_out, want) <= 1.0

    batch = f64ish.mfcc_batch_f64ish(_t(sig), cfg)
    frames = framing.extract_frames(framing.preemphasis(_t(sig)), nfft, hop)
    fe = MFCC(cfg, precision="f64ish", device="cpu")
    streamed, _ = StreamingMFCC(cfg, precision="f64ish",
                                device="cpu").process(_t(sig), 149)
    outs = {
        "batch": batch,
        "frames": f64ish.mfcc_frames_f64ish(frames, cfg),
        "MFCC.forward int16": fe(_t(sig.astype(np.int16))),
        "MFCC.frames": fe.frames(frames),
        "float_ops.mfcc_batch": float_ops.mfcc_batch(_t(sig), cfg,
                                                     precision="f64ish"),
        "streamed C=149": torch.from_numpy(np.stack(streamed)),
    }
    for name, got in outs.items():
        got = got.numpy()
        assert got.shape == want.shape and got.dtype == np.float32, name
        assert np.abs(got - jax_out).max() <= TOL_DF32, name
        assert gate_units(got, want) <= 0.5, name
        assert np.array_equal(got, batch.numpy()), name


@pytest.fixture(scope="module")
def k7_jax():
    """One JAX K7 interpret-mode call on 4 streams: 2 on the wire grid
    (integer-valued), 2 normalized to [-1, 1] (off the grid)."""
    on = _signal(512, 170, seed=5)
    off = _signal(512, 170, seed=6) / np.float32(32768)
    sig = np.concatenate([on, off])
    got = np.asarray(pallas_df32.mfcc_f64ish_pallas(
        sig, _jcfg(MFCCConfig()), interpret=True))
    return sig, got


def test_matches_jax_k7_on_grid(k7_jax):
    """On the wire grid the port equals JAX K7 within 2e-5 (measured
    3.1e-6), and both sit inside the gate."""
    sig, k7 = k7_jax
    port = f64ish.mfcc_f64ish(_t(sig[:2]), MFCCConfig()).numpy()
    assert np.abs(port - k7[:2]).max() <= TOL_DF32
    want = _oracle(sig[:2], MFCCConfig())
    assert gate_units(k7[:2], want) <= 1.0
    assert gate_units(port, want) <= 0.5


def test_jax_k7_truncates_off_grid_port_follows_df32(k7_jax):
    """A disagreement inside the reference: off the 2^-5 grid, JAX K7
    truncates x*32 (``pallas_df32.py:272``) where ``df32`` rounds it half to
    even; they differ by whole units (measured 3.76 max-abs).  The port
    rounds as ``df32`` does (the pipeline's route) and follows it within
    2e-5 (measured 4.3e-6)."""
    sig, k7 = k7_jax
    off = sig[2:]
    jax_df32 = _jax_df32(off, MFCCConfig())
    port = f64ish.mfcc_f64ish(_t(off), MFCCConfig()).numpy()
    assert np.abs(k7[2:] - jax_df32).max() > 1.0
    assert np.abs(port - jax_df32).max() <= TOL_DF32
    assert np.abs(port - k7[2:]).max() > 1.0
    # the grid is no place for [-1, 1] audio: both far from the oracle
    # (measured K7 9.62, df32 7.28 max-abs)
    want = _oracle(off, MFCCConfig())
    assert np.abs(k7[2:] - want).max() > 1.0
    assert np.abs(jax_df32 - want).max() > 1.0


def test_wire_grid_is_defined_for_int16_range():
    """``wire_grid=True`` beyond int16 range: JAX takes round(x*32) to
    int32, which wraps past 2^26; the port rounds in float64 and does not
    emulate the wrap.  On 2^20-scaled samples they part by whole units
    (measured 133.5 max-abs); ``wire_grid=False`` is the route there."""
    cfg = MFCCConfig()
    sig = (_signal(512, 170, seed=4) * np.float32(2.0 ** 20)).astype(
        np.float32)
    port = f64ish.mfcc_batch_f64ish(_t(sig), cfg).numpy()
    assert np.abs(port - _jax_df32(sig, cfg)).max() > 100.0
    assert gate_units(port, _oracle(sig, cfg)) <= 1.0


def test_f32_emphasis_misses_the_gate_off_scale():
    """A finding in the reference's definition: with ``wire_grid=False`` at
    a non-power-of-two scale the f32 emphasis, rounded twice as the port
    and op-by-op JAX compute it, misses the f64ish gate (measured 6.33
    gate units at x 0.37), while float64 emphasis holds it (0.16).
    Under ``jax.jit`` on the CPU XLA contracts JAX's emphasis into one FMA
    (one rounding), so jitted ``df32`` reads 0.51 here."""
    cfg = MFCCConfig()
    sig = (_tonal(2, 512 + 4 * 170, seed=3) * np.float32(0.37)).astype(
        np.float32)
    want = _oracle(sig, cfg)
    port = f64ish.mfcc_batch_f64ish(_t(sig), cfg, wire_grid=False).numpy()
    assert gate_units(port, want) > 1.0
    emph64 = framing.preemphasis(_t(sig).double())
    frames64 = framing.extract_frames(emph64, 512, 170)
    exact = fladder.ladder_tail_plain(
        frames64, fladder.default_operators(cfg, frames64.device), cfg)
    assert gate_units(exact.numpy(), want) <= 0.5
    jitted = np.asarray(jax.jit(jframing.preemphasis)(jnp.asarray(sig)))
    one_rounding = emph64.float().numpy()
    assert np.array_equal(jitted, one_rounding)
    assert gate_units(_jax_df32(sig, cfg, wire_grid=False), want) <= 1.0


@pytest.mark.parametrize("scale", [1.0 / 32768.0, 2.0 ** 20])
def test_wire_grid_false_arbitrary_scale(scale):
    """``wire_grid=False`` at the scales ``tests/test_float_parity.py``
    holds: within 1 gate unit of the oracle of the same values (measured
    0.14 and 0.20; JAX df32 0.40 and 0.43).  Power-of-two scales keep the
    f32 emphasis of integer samples exact."""
    cfg = MFCCConfig()
    sig = (_signal(512, 170, seed=4) * scale).astype(np.float32)
    want = _oracle(sig, cfg)
    port = f64ish.mfcc_batch_f64ish(_t(sig), cfg, wire_grid=False).numpy()
    assert gate_units(port, want) <= 1.0
    assert gate_units(_jax_df32(sig, cfg, wire_grid=False), want) <= 1.0


def test_grid_rounds_half_to_even():
    """Values with x*32 exactly at k + 0.5 round to the even k, as
    ``jnp.round`` does in ``df32`` (never half away from zero, never
    truncated)."""
    cfg = MFCCConfig()
    rng = np.random.default_rng(11)
    k = rng.integers(-2 ** 19, 2 ** 19, (2, 3, 512))
    frames = ((k + 0.5) / 32).astype(np.float32)
    assert np.array_equal(frames.astype(np.float64) * 32, k + 0.5)  # exact
    rounded = (np.round(frames.astype(np.float64) * 32) / 32)
    assert np.array_equal(rounded * 32 % 2, np.zeros_like(rounded))  # even
    got = f64ish.mfcc_frames_f64ish(_t(frames), cfg)
    want = f64ish.mfcc_frames_f64ish(_t(rounded.astype(np.float32)), cfg,
                                     wire_grid=False)
    assert torch.equal(got, want)
    jax_frames = np.asarray(jax.jit(functools.partial(
        df32.mfcc_frames_f64ish, cfg=_jcfg(cfg)))(jnp.asarray(frames)))
    assert np.abs(got.numpy() - jax_frames).max() <= TOL_DF32


def test_emphasis_is_f32_rounded_twice():
    """The pre-emphasis of non-integer f32 input is ``x - 0.96875*prev`` in
    f32 with two roundings, bit for bit what the JAX package's
    ``framing.preemphasis`` gives when run op by op (under ``jax.jit`` on
    the CPU XLA contracts it into one FMA; ROADMAP §C)."""
    sig = (_signal(512, 170, seed=8) * np.float32(0.37)).astype(np.float32)
    two = sig.copy()
    two[:, 1:] = sig[:, 1:] - np.float32(0.96875) * sig[:, :-1]
    port = framing.preemphasis(_t(sig)).numpy()
    assert np.array_equal(port, two)
    assert np.array_equal(port, np.asarray(jframing.preemphasis(
        jnp.asarray(sig))))
    frames = framing.extract_frames(_t(two), 512, 170)
    assert torch.equal(
        f64ish.mfcc_batch_f64ish(_t(sig), MFCCConfig(), wire_grid=False),
        f64ish.mfcc_frames_f64ish(frames, MFCCConfig(), wire_grid=False))


def test_silence_is_not_finite():
    """Digital silence: neither JAX nor the port is finite (log2 of a zero
    mel energy; f64ish has no mel_floor)."""
    cfg = MFCCConfig()
    zeros = np.zeros((2, 512 + 6 * 170), np.float32)
    assert not np.isfinite(_jax_df32(zeros, cfg)).all()
    port = f64ish.mfcc_batch_f64ish(_t(zeros), cfg).numpy()
    assert not np.isfinite(port).all()
    assert np.isneginf(port[..., 0]).all()


@pytest.mark.parametrize("cfg", [
    MFCCConfig(window_samples=400),
    MFCCConfig(nfft=128, step=43, nfilters=16, nceptrums=16)],
    ids=["windowlen400", "nfft128"])
def test_out_of_family_takes_the_float64_chain(cfg):
    """Configs outside K7's family run the float64 chain over all
    nbins_float bins, as ``df32`` handles any config: within 2e-5 of it
    (the oracle frames nfft-long windows, so it reads nfft 128 only)."""
    T = cfg.windowlen + 6 * cfg.hop
    sig = _tonal(2, T, seed=9)
    jax_out = _jax_df32(sig, cfg)
    got = MFCC(cfg, precision="f64ish", device="cpu")(_t(sig))
    assert got.shape == jax_out.shape == (2, 7, cfg.nceptrums)
    assert np.abs(got.numpy() - jax_out).max() <= TOL_DF32
    if cfg.windowlen == cfg.nfft:
        assert gate_units(got.numpy(), _oracle(sig, cfg)) <= 1.0
    assert torch.equal(got, f64ish.mfcc_batch_f64ish(_t(sig), cfg))


# -- modules ---------------------------------------------------------------------

def test_module_ignores_method_dtype_and_mel_floor():
    """As in JAX, ``precision="f64ish"`` ignores ``method``, ``dtype`` and
    ``mel_floor``; ``float_ops`` ignores them and ``operators`` too."""
    sig = _t(_signal(512, 170, seed=10))
    want = MFCC(precision="f64ish", device="cpu")(sig)
    for kw in (dict(method="rfft"), dict(mel_floor=1.0),
               dict(dtype=torch.float64), dict(method="segmented")):
        assert torch.equal(MFCC(precision="f64ish", device="cpu", **kw)(sig),
                           want), kw
        assert torch.equal(float_ops.mfcc_batch(sig, precision="f64ish",
                                                **kw), want), kw


def test_module_operators_reach_f64ish():
    """Operators loaded through state_dict reach the f64ish route (K7's
    tail reads the module's window, mel and dct)."""
    state = MFCC(device="cpu").state_dict()
    state["dct"] = state["dct"] * 2
    fe = MFCC(precision="f64ish", device="cpu")
    fe.load_state_dict(state)
    sig = _t(_signal(512, 170, seed=12))
    ops = fladder.LadderOperators(fe.ladder_window, fe.mel[:256], fe.dct,
                                  fe.mel_band)
    got = fe(sig)
    assert torch.equal(got, f64ish.mfcc_f64ish(sig, operators=ops))
    base = MFCC(precision="f64ish", device="cpu")(sig)
    assert torch.equal(got, 2 * base)      # a power-of-two DCT scale is exact


@pytest.mark.parametrize("C", [149, 1024])
def test_streaming_chunked_equals_batch(C):
    """Chunked f64ish equals batch f64ish for any chunking, flush steps
    included, with a reset and int16 chunks; the state is f32 whatever
    ``dtype`` asks."""
    sig = _tonal(3, 512 + 20 * 170 + 77, seed=C)
    sm = StreamingMFCC(precision="f64ish", device="cpu",
                       dtype=torch.float64, mel_floor=1.0)
    assert sm.init(1).buffer.dtype == torch.float32
    outs, _ = sm.process(_t(sig.astype(np.int16)), C)
    batch = f64ish.mfcc_batch_f64ish(_t(sig)).numpy()
    for s in range(3):
        assert np.array_equal(outs[s], batch[s])
    # a reset mid-stream restarts stream 1 on its remaining samples
    cut = 2 * C
    reset = {2: np.array([False, True, False])}
    outs, _ = sm.process(_t(sig), C, reset_at=reset)
    tail = f64ish.mfcc_batch_f64ish(_t(sig[1:2, cut:])).numpy()[0]
    assert np.array_equal(outs[1][-len(tail):], tail)


# -- split and segmented -----------------------------------------------------------

def test_bf16_trunc_matches_jax():
    """The bit-masked round to bf16, nearest even, bit for bit as JAX's
    ``_bf16_trunc`` (ties, negatives, subnormals, inf)."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 1e4,
        np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 1e-40,
                  -1e-40, np.inf, -np.inf, 0.0, -0.0], np.float32)])
    got = float_ops._bf16_trunc(_t(x)).numpy()
    want = np.asarray(jfloat_ops._bf16_trunc(jnp.asarray(x)))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_split_matmul_accuracy():
    """``split_matmul`` keeps ~16 mantissa bits: < 2e-5 relative to float64
    (``tests/test_pallas.py``), and within 1e-6 relative of JAX's (the same
    limbs; only the f32 summation order differs)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 512)).astype(np.float32) * 1e4
    b = rng.standard_normal((512, 128)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = float_ops.split_matmul(_t(a), _t(b)).numpy()
    scale = np.abs(want).max()
    assert (np.abs(got - want) / scale).max() < 2e-5
    jgot = np.asarray(jax.jit(jfloat_ops.split_matmul)(jnp.asarray(a),
                                                       jnp.asarray(b)))
    assert (np.abs(got - jgot) / scale).max() < 1e-6


@pytest.mark.parametrize("kw", [dict(precision="split"),
                                dict(precision="split", method="rfft"),
                                dict(method="segmented"),
                                dict(method="segmented", precision="split")],
                         ids=["split", "split-rfft", "segmented",
                              "segmented-split"])
def test_split_and_segmented_match_jax(kw):
    """``precision="split"`` and ``method="segmented"`` against JAX's
    ``float_ops.mfcc_batch`` (5e-5; measured 4.3e-6 to 1.9e-5) and the
    oracle (5e-4, the float contract; measured 1.5e-5 to 3.6e-4)."""
    cfg = MFCCConfig()
    sig = _tonal(2, 512 + 4 * 170, seed=7)
    jax_out = np.asarray(jax.jit(functools.partial(
        jfloat_ops.mfcc_batch, cfg=_jcfg(cfg), **kw))(jnp.asarray(sig)))
    got = float_ops.mfcc_batch(_t(sig), cfg, **kw).numpy()
    assert np.abs(got - jax_out).max() <= TOL_CHAIN
    assert np.abs(got - _oracle(sig, cfg)).max() <= GATE
    fe = MFCC(cfg, device="cpu", **kw)
    assert np.array_equal(fe(_t(sig)).numpy(), got)


@pytest.mark.parametrize("step", [171, 256])
def test_segmented_hops(step):
    """Segments at an odd hop (nfft % hop = 170) and at hop 256 (no
    remainder) equal the framed DFT chain within f32 noise."""
    cfg = MFCCConfig(step=step)
    sig = _t(_tonal(2, 512 + 5 * step + 3, seed=step))
    seg = float_ops.mfcc_batch(sig, cfg, method="segmented")
    dft = float_ops.mfcc_batch(sig, cfg)
    assert seg.shape == dft.shape == (2, 6, 32)
    assert (seg - dft).abs().max() <= TOL_CHAIN
    seg_split = float_ops.mfcc_batch(sig, cfg, method="segmented",
                                     precision="split")
    assert (seg_split - float_ops.mfcc_batch(sig, cfg, precision="split")
            ).abs().max() <= TOL_CHAIN


def test_segmented_falls_back_for_short_windows():
    """windowlen < nfft: the segment layout cannot hold zero-padded frames,
    so ``method="segmented"`` runs the framed DFT, as in JAX."""
    cfg = MFCCConfig(window_samples=400)
    sig = _t(_tonal(2, 400 + 6 * 170, seed=1))
    assert torch.equal(float_ops.mfcc_batch(sig, cfg, method="segmented"),
                       float_ops.mfcc_batch(sig, cfg))


def test_partial_extractors_take_split_and_f64ish_as_f32():
    """``power_spectrum_frames`` / ``log_mel_frames`` compute "split" and
    "f64ish" in full f32, as ``_matmul_precision`` gives them in JAX."""
    sig = _t(_signal(512, 170, seed=2))
    frames = framing.extract_frames(framing.preemphasis(sig), 512, 170)
    for fn in (float_ops.power_spectrum_frames, float_ops.log_mel_frames):
        want = fn(frames)
        for precision in ("split", "f64ish"):
            assert torch.equal(fn(frames, precision=precision), want)


def test_streaming_split_equals_batch():
    """``StreamingMFCC(precision="split")`` runs the split chain on every
    step: chunked within f32 noise of the batch split chain.  On this
    longer input split misses the float gate, the port (measured 1.32e-3)
    and JAX (1.32e-3) alike: its bf16 limbs keep ~16 mantissa bits."""
    sig = _tonal(2, 512 + 12 * 170 + 5, seed=13)
    outs, _ = StreamingMFCC(precision="split", device="cpu").process(
        _t(sig), 300)
    batch = float_ops.mfcc_batch(_t(sig), precision="split").numpy()
    assert np.abs(np.stack(outs) - batch).max() <= TOL_CHAIN
    want = _oracle(sig, MFCCConfig())
    jax_split = np.asarray(jax.jit(functools.partial(
        jfloat_ops.mfcc_batch, cfg=_jcfg(MFCCConfig()),
        precision="split"))(jnp.asarray(sig)))
    assert np.abs(batch - want).max() > GATE
    assert np.abs(jax_split - want).max() > GATE
    assert np.abs(batch - jax_split).max() <= TOL_CHAIN
