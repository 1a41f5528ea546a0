"""The torch package's K5 (split-DFT, ``precision="fast"``), K5-frames, K6
(odd hop) and the split-DFT serving step on the CPU, through their plain
versions, against the JAX package's Pallas kernels in interpret mode and
the float64 oracle, on the same numpy inputs.

Tolerances, each with its reason:

  * plain version vs JAX kernel: 2e-4.  Both take the same bf16 limbs; the
    port sums the exact limb products in float64 and rounds once, the JAX
    kernel sums them in f32, and log2 of the quiet mel bands amplifies the
    difference (measured <= 1.4e-4 on these inputs).
  * vs the float64 oracle: 2e-3 at 3 and 4 passes (the fast mode's gate,
    ``bench.FAST_GATE`` and ``test_pallas_interpret.py``), 5e-4 at 6 (the
    float contract); K6 computes in float64 like K1: 5e-5.
  * carries, counts, masks and prev: bit-identical.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import mfcc_tpu
from mfcc_tpu import streaming as jstreaming
from mfcc_tpu.config import MFCCConfig as JaxConfig
from mfcc_tpu.ops import framing as jframing, pallas_mfcc, pallas_stream
from mfcc_tpu.ref import float_ref

from mfcc_tpu_torch import MFCC, MFCCConfig, StreamingMFCC
from mfcc_tpu_torch.ops import fladder, float_fused, framing, stream_fused

TOL_JAX = 2e-4
FAST_GATE = 2e-3
GATE = 5e-4
TOL_F64 = 5e-5


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


def _rich(n, seed=1234):
    """conftest's ``audio_int16`` recipe at any length: chirp + tone +
    noise, int16-valued."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = (9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
           + 5000 * np.sin(2 * np.pi * 1200 * t)
           + 1500 * rng.standard_normal(n))
    return np.clip(sig, -32768, 32767).astype(np.int16)


def _two(a):
    """``test_pallas_interpret.sig2``: a stream and a shifted, scaled copy."""
    a = a.astype(np.float32)
    return np.stack([a, np.round(np.roll(a, 250) * 0.7)])


@pytest.fixture(scope="module")
def sig2(audio_int16):
    return _two(audio_int16)


def _signal(nfft, sig2):
    """sig2 (~7 frames at 512) where it holds frames; a longer rich signal
    at nfft 1024 (sig2 holds one 1024-point frame)."""
    return sig2 if nfft < 1024 else _two(_rich(1024 + 6 * 340))


def _jcfg(cfg):
    return JaxConfig(nfft=cfg.nfft, step=cfg.step,
                     window_samples=cfg.window_samples)


def _oracle(sig, cfg):
    return np.stack([float_ref.mfcc_float(s, _jcfg(cfg)) for s in sig])


HOPS = {256: 86, 512: 170, 1024: 340}


# -- configs and operators -------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, dict(nfft=256, step=86), dict(nfft=1024, step=340), dict(step=171),
    dict(step=160, window_samples=400), dict(nfft=2048, step=512),
])
def test_config_ok_matches_jax(kw):
    cfg = MFCCConfig(**kw)
    assert (float_fused.float_config_ok(cfg)
            == pallas_mfcc.pallas_float_config_ok(JaxConfig(**kw)))


@pytest.mark.parametrize("nfft", [256, 512, 1024])
def test_radix2_operators_are_jax_in_natural_order(nfft):
    """The natural-order operators are the rows of JAX's unpacked operator
    (cos j = 0..nfft/4, -sin j = 1..nfft/4-1), up to the float64 rounding
    of the angle (the port reads entry j*m mod nh of one table), and the
    window halves, twiddles, mel columns and DCT are JAX's."""
    cfg = MFCCConfig(nfft=nfft, step=HOPS[nfft])
    ops = float_fused.radix2_operators(cfg)
    csp, we, wo, twc, tws, mela, _, _, dct_t = \
        pallas_mfcc._radix2_operators(_jcfg(cfg), False)
    nh2 = nfft // 4
    nqp = csp.shape[0] // 2
    want = np.concatenate([csp[: nh2 + 1], csp[nqp + 1: nqp + nh2]])
    assert ops.dft.shape == want.shape == (nfft // 2, nfft // 2)
    assert np.abs(ops.dft - want).max() <= 2 * np.spacing(np.float32(1 / nfft))
    assert np.array_equal(ops.we, we[:, 0]) and np.array_equal(ops.wo, wo[:, 0])
    assert np.array_equal(ops.tw, np.stack([twc[:nh2, 0], tws[:nh2, 0]], 1))
    assert np.array_equal(ops.mel[: nh2 + 1], mela[:, : nh2 + 1].T)
    assert np.array_equal(ops.dct, dct_t.T)
    # the rows are the table's entries j*m mod nh
    jm = np.outer(np.arange(nfft // 2), np.arange(nfft // 2)) % (nfft // 2)
    assert np.array_equal(ops.dft[3], ops.cos[jm[3]])
    assert np.array_equal(ops.dft[nh2 + 3], ops.sin[jm[3]])


@pytest.mark.parametrize("nfft", [256, 512, 1024])
def test_split_dft_bins_in_natural_order(nfft):
    """With identity mel and DCT, the 6-pass tail returns log2 of the power
    on bins [0, nfft/2) in natural order: bin 0, bin nfft/4 (the cos row
    of j = nfft/4) and the B half (bins nh - j) against float64 rfft."""
    cfg = MFCCConfig(nfft=nfft, step=HOPS[nfft])
    nh = nfft // 2
    ops = float_fused.default_operators(cfg, torch.device("cpu"))
    eye = torch.eye(nh)
    ops = ops._replace(mel=eye, dct=eye)
    frames = torch.from_numpy(np.random.default_rng(nfft).normal(
        0, 3000, (3, nfft)).astype(np.float32))
    got = float_fused.radix2_tail_plain(frames, ops, cfg, 6)
    win = torch.from_numpy(float_fused.radix2_operators(cfg).we).double()
    w = torch.stack([win, torch.from_numpy(
        float_fused.radix2_operators(cfg).wo).double()], -1).reshape(-1)
    spec = torch.fft.rfft(frames.double() * w, dim=-1)[:, :nh] / nfft
    want = torch.log2(spec.real ** 2 + spec.imag ** 2)
    assert (got - want).abs().max().item() <= 1e-3
    for k in (0, 1, nfft // 4, nfft // 4 + 1, nh - 1):
        assert (got[:, k] - want[:, k]).abs().max().item() <= 1e-4, k


# -- K5 against the JAX kernel (interpret mode) and the oracle ---------------------

@pytest.mark.parametrize("passes", [3, 4, 6])
@pytest.mark.parametrize("nfft", [256, 512, 1024])
def test_radix2_plain_matches_interpret(cpu, sig2, nfft, passes):
    cfg = MFCCConfig(nfft=nfft, step=HOPS[nfft])
    sig = _signal(nfft, sig2)
    with jax.default_device(cpu):
        want = np.asarray(pallas_mfcc.mfcc_pallas_radix2(
            sig, _jcfg(cfg), interpret=True, dft_passes=passes))
    got = float_fused.mfcc_radix2(torch.from_numpy(sig), cfg,
                                  dft_passes=passes).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL_JAX
    gate = GATE if passes == 6 else FAST_GATE
    assert np.abs(got - _oracle(sig, cfg)).max() <= gate
    # int16 wire input gives the same cepstra
    got16 = float_fused.mfcc_radix2(torch.from_numpy(sig.astype(np.int16)),
                                    cfg, dft_passes=passes).numpy()
    assert np.array_equal(got, got16)


@pytest.mark.parametrize("passes", [3, 6])
def test_frames_float_plain_matches_interpret(cpu, sig2, passes):
    cfg = MFCCConfig()
    emph = np.asarray(jframing.preemphasis(sig2))
    frames = np.asarray(jframing.extract_frames(emph, 512, 170))
    with jax.default_device(cpu):
        want = np.asarray(pallas_mfcc.mfcc_pallas_frames_float(
            frames, _jcfg(cfg), interpret=True, dft_passes=passes))
    got = float_fused.mfcc_frames_float(torch.from_numpy(np.array(frames)),
                                        cfg, dft_passes=passes).numpy()
    assert got.shape == want.shape == (2, 5, 32)
    assert np.abs(got - want).max() <= TOL_JAX
    gate = GATE if passes == 6 else FAST_GATE
    assert np.abs(got - _oracle(sig2, cfg)).max() <= gate
    # float64 frames are cast to f32, as JAX does
    got64 = float_fused.mfcc_frames_float(
        torch.from_numpy(np.array(frames, np.float64)), cfg,
        dft_passes=passes).numpy()
    assert np.array_equal(got, got64)


def test_frames_equal_batch_on_the_same_frames(sig2):
    """K5-frames on K5's own emphasized frames gives K5's cepstra."""
    cfg = MFCCConfig()
    x = torch.from_numpy(sig2)
    frames = framing.extract_frames(framing.preemphasis(x), 512, 170)
    for passes in (3, 6):
        a = float_fused.mfcc_frames_float(frames, cfg, dft_passes=passes)
        b = float_fused.mfcc_radix2(x, cfg, dft_passes=passes)
        assert (a - b).abs().max().item() <= 1e-5


# -- K6 ----------------------------------------------------------------------------

@pytest.mark.parametrize("step", [171, 165])
def test_recomp_t_matches_interpret(cpu, sig2, step):
    """K6 at an odd hop: its plain version (K1's, float64 inside) against
    the JAX dense-DFT kernel and the oracle."""
    cfg = MFCCConfig(step=step)
    with jax.default_device(cpu):
        want = np.asarray(pallas_mfcc.mfcc_pallas_recomp_t(
            sig2, _jcfg(cfg), interpret=True))
    got = float_fused.mfcc_recomp_t(torch.from_numpy(sig2), cfg).numpy()
    assert got.shape == want.shape == (2, cfg.n_frames(sig2.shape[1]), 32)
    assert np.abs(got - want).max() <= GATE
    assert np.abs(got - _oracle(sig2, cfg)).max() <= TOL_F64
    assert np.array_equal(got, float_fused.mfcc_recomp_t(
        torch.from_numpy(sig2.astype(np.int16)), cfg).numpy())


# -- the split-DFT serving step ------------------------------------------------------

P = 511


@pytest.mark.parametrize("ts,layout", [(False, "time"), (True, "time"),
                                       (False, "positions")],
                         ids=["plain", "transposed_state", "positions"])
def test_stream_split_plain_matches_interpret(cpu, ts, layout):
    """``stream_step_float(dft_passes=3)``'s plain version against
    ``pallas_stream.stream_step_float(dft_passes=3)`` in interpret mode over
    the multi-step reset run of ``test_pallas_stream.py``: masks, counts,
    prev and the carry equal, features on valid slots within TOL_JAX."""
    rng = np.random.default_rng(42)
    S, C, cfg = 3, 600, MFCCConfig()
    carry = np.zeros((S, P), np.float32)
    count = np.zeros(S, np.int32)
    prev = np.zeros(S, np.float32)
    for step in range(4):
        x = rng.integers(-25000, 25000, (S, C)).astype(np.float32)
        if step == 2:
            count[::2] = 0
            prev[::2] = 0
        start = (P - count).astype(np.int32)
        xin = x.T.copy() if layout == "positions" else x
        cin = carry.T.copy() if ts else carry
        with jax.default_device(cpu):
            jf, jb = pallas_stream.stream_step_float(
                *(jnp.asarray(a) for a in (cin, xin, start, prev)),
                _jcfg(cfg), interpret=True, transposed_state=ts,
                chunk_layout=layout, dft_passes=3)
        tf, tb = stream_fused.stream_step_float(
            *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (cin, xin, start, prev)), cfg,
            transposed_state=ts, chunk_layout=layout, dft_passes=3)
        assert np.array_equal(tb.numpy(), np.asarray(jb)), step
        total = count + C
        n_valid = np.maximum((total - 512) // 170 + 1, 0)
        jf, tf = np.asarray(jf), tf.numpy()
        for s in range(S):
            n = n_valid[s]
            assert np.isfinite(tf[s, :n]).all()
            if n:
                assert np.abs(tf[s, :n] - jf[s, :n]).max() <= TOL_JAX, step
        carry = tb.numpy().T.copy() if ts else tb.numpy()
        count = (total - n_valid * 170).astype(np.int32)
        prev = x[:, -1].copy()


def test_stream_split_carry_is_k4_float_carry():
    """The split-DFT step's new carry is K4-float's, and its frames are the
    ladder step's frames through another tail."""
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.integers(-3000, 3000, (3, P)).astype(np.float32))
    x = torch.from_numpy(rng.integers(-32768, 32768, (3, 700)).astype(np.int16))
    start = torch.tensor([0, 300, 511], dtype=torch.int32)
    prev = torch.tensor([1.0, -2.0, 3.0])
    f6, b6 = stream_fused.stream_step_float(buf, x, start, prev)
    for passes in (3, 4):
        f3, b3 = stream_fused.stream_step_float(buf, x, start, prev,
                                                dft_passes=passes)
        assert torch.equal(b3, b6)
        assert f3.shape == f6.shape == (3, 5, 32)
        assert (f3 - f6).abs().max().item() <= 2e-2


def _chunked_plain(x, C, passes):
    """Full chunks of (S, T) int16 ``x`` through the split step's plain
    version, with the streaming bookkeeping; the valid frames per stream."""
    cfg = MFCCConfig()
    S, T = x.shape
    carry = torch.zeros(S, P)
    count = torch.zeros(S, dtype=torch.int32)
    prev = torch.zeros(S)
    outs = [[] for _ in range(S)]
    for ci in range(T // C):
        chunk = x[:, ci * C:(ci + 1) * C]
        f, carry = stream_fused.stream_step_float(
            carry, chunk, (P - count).to(torch.int32), prev, cfg,
            dft_passes=passes)
        total = count + C
        n_valid = torch.clamp_min((total - 512) // 170 + 1, 0)
        for s in range(S):
            outs[s].append(f[s, : int(n_valid[s])])
        count = (total - n_valid * 170).to(torch.int32)
        prev = chunk[:, -1].float()
    return [torch.cat(o) for o in outs]


@pytest.mark.parametrize("C", [149, 600])
def test_chunked_fast_equals_batch_fast(C):
    """Streaming int16 through the split step's plain version equals K5's
    plain version on the whole signal: the same f32 frames through the same
    tail (up to the f32 mel and DCT products' batch shapes)."""
    x = torch.from_numpy(np.stack([_rich(4000, 5), _rich(4000, 6)]))
    got = _chunked_plain(x, C, 3)
    n = (4000 // C) * C
    want = float_fused.mfcc_radix2(x[:, :n], MFCCConfig(), dft_passes=3)
    for s in range(2):
        assert got[s].shape == want[s].shape
        assert (got[s] - want[s]).abs().max().item() <= 1e-5


# -- the slice as a whole on the CPU -------------------------------------------------

def test_fast_module_matches_jax(sig2):
    """``MFCC(precision="fast")`` on the CPU is the "highest" chain, as
    ``mfcc_tpu.MFCC(precision="fast")`` is off its TPU."""
    fe = MFCC(precision="fast", device="cpu")
    assert fe._route == "radix2" and fe._frames_route == "radix2"
    got = fe(torch.from_numpy(sig2)).numpy()
    want = np.asarray(mfcc_tpu.MFCC(precision="fast")(sig2))
    assert np.abs(got - want).max() <= 1e-4
    assert np.abs(got - _oracle(sig2, MFCCConfig())).max() <= GATE


def test_odd_hop_module_matches_jax(sig2):
    fe = MFCC(MFCCConfig(step=171), device="cpu")
    assert fe._route == "recomp_t"
    got = fe(torch.from_numpy(sig2)).numpy()
    want = np.asarray(mfcc_tpu.MFCC(JaxConfig(step=171))(sig2))
    assert np.abs(got - want).max() <= 1e-4
    # the CPU route is the chain; K6's plain version agrees with it
    k6 = float_fused.mfcc_recomp_t(torch.from_numpy(sig2), fe.cfg).numpy()
    assert np.abs(got - k6).max() <= 1e-4


def test_fast_streaming_matches_jax():
    rng = np.random.default_rng(8)
    sig = rng.integers(-20000, 20000, (2, 1500)).astype(np.float32)
    got, state = StreamingMFCC(precision="fast", device="cpu").process(sig,
                                                                         400)
    want, jstate = jstreaming.StreamingMFCC(
        JaxConfig(), precision="fast").process(sig, 400)
    for s in range(2):
        assert got[s].shape == want[s].shape
        assert np.abs(got[s] - want[s]).max() <= 1e-3
    for name in ("buffer", "count", "prev"):
        assert np.array_equal(getattr(state, name).numpy(),
                              np.asarray(getattr(jstate, name))), name


# -- wrapper checks ----------------------------------------------------------------

def test_wrapper_checks():
    x = torch.zeros(2, 2000)
    with pytest.raises(ValueError, match="dft_passes"):
        float_fused.mfcc_radix2(x, dft_passes=5)
    with pytest.raises(ValueError, match="even hop"):
        float_fused.mfcc_radix2(x, MFCCConfig(step=171))
    with pytest.raises(ValueError, match="family"):
        float_fused.mfcc_recomp_t(x, MFCCConfig(step=160, window_samples=400))
    with pytest.raises(ValueError, match="frames"):
        float_fused.mfcc_frames_float(torch.zeros(3, 256))
    meta = torch.zeros(2, 2000, device="meta")
    for fn in (float_fused.mfcc_radix2, float_fused.mfcc_recomp_t):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            fn(meta)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        float_fused.mfcc_frames_float(torch.zeros(3, 512, device="meta"))


def test_cpu_never_launches(sig2):
    before = dict(float_fused.LAUNCHES)
    x = torch.from_numpy(sig2)
    float_fused.mfcc_radix2(x, dft_passes=3)
    float_fused.mfcc_recomp_t(x, MFCCConfig(step=171))
    float_fused.mfcc_frames_float(torch.zeros(2, 512))
    MFCC(precision="fast", device="cpu")(x)
    assert float_fused.LAUNCHES == before


def test_split_step_needs_the_operators(monkeypatch):
    """Where the split-DFT operators cannot exist (a non-zero Nyquist mel
    row) the split step raises, as ``_radix2_operators`` asserts; 6 passes
    outside K1's family and other geometries raise too."""
    buf, x = torch.zeros(2, P), torch.zeros(2, 300)
    start, prev = torch.zeros(2, dtype=torch.int32), torch.zeros(2)
    cfg = MFCCConfig(nfilters=30, nceptrums=30)
    monkeypatch.setattr(fladder, "nyquist_mel_row_zero", lambda c: False)
    with pytest.raises(ValueError, match="Nyquist"):
        stream_fused.stream_step_float(buf, x, start, prev, cfg,
                                       dft_passes=3)
    with pytest.raises(ValueError, match="family"):
        stream_fused.stream_step_float(buf, x, start, prev, cfg)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="family"):
        stream_fused.stream_step_float(buf, x, start, prev,
                                       MFCCConfig(step=171), dft_passes=3)
    with pytest.raises(ValueError, match="dft_passes"):
        stream_fused.stream_step_float(buf, x, start, prev, dft_passes=2)


def _make_audio(S, T, seed=0):
    """``bench.make_audio`` (and chip_smoke.py's): a chirp and a tone shared
    by all streams plus per-stream uniform noise, integer-valued f32."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000.0
    base = (9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
            + 4000 * np.sin(2 * np.pi * 900 * t))
    noise = rng.integers(-1500, 1500, (S, T))
    return np.round(np.clip(base[None, :] + noise,
                            -32768, 32767)).astype(np.float32)


@pytest.mark.parametrize("S,T,seed,lo,hi", [
    (1024, 63_922, 0, 1e-2, 2e-2),      # chip_smoke's headline input
    (64, 65_536, 5, 0.1, 0.2),          # chip_smoke's streamed input
], ids=["headline", "streamed"])
def test_fast_mode_long_input_reads_as_jax(cpu, S, T, seed, lo, hi):
    """The fast gate 2e-3 holds on the JAX bench's gate input (2 streams x
    5 frames, ``bench.accuracy_of``) but not on 8 spread streams x 4 s of
    chip_smoke.py's inputs, for the JAX kernel as for the port: the 3-pass
    limb split reads in [lo, hi] there.  The port's plain version stays
    within 1e-3 of the JAX kernel (f32 vs float64 sums of the limb
    products)."""
    cfg = MFCCConfig()
    gate_in = _make_audio(2, 512 + 4 * 170, seed=7)
    got = float_fused.mfcc_radix2(torch.from_numpy(gate_in), cfg,
                                  dft_passes=3).numpy()
    assert np.abs(got - _oracle(gate_in, cfg)).max() <= FAST_GATE
    sig = _make_audio(S, T, seed)[np.linspace(0, S - 1, 8).astype(int)]
    want = _oracle(sig, cfg)
    with jax.default_device(cpu):
        jax_out = np.asarray(pallas_mfcc.mfcc_pallas_radix2(
            sig, _jcfg(cfg), interpret=True, dft_passes=3))
    got = float_fused.mfcc_radix2(torch.from_numpy(sig), cfg,
                                  dft_passes=3).numpy()
    jax_err = np.abs(jax_out - want).max()
    port_err = np.abs(got - want).max()
    assert lo <= jax_err <= hi, jax_err
    assert lo <= port_err <= hi, port_err
    assert np.abs(got - jax_out).max() <= 1e-3
