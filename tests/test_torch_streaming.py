"""The torch package's streaming path on the CPU: ``StreamingMFCC``, its
chunk step and the plain versions of the serving-step kernels K4, against
the JAX package on the same numpy inputs and against the oracles.

Tolerances: the carry, count, prev and mask are bit-identical to JAX's; INT
features are element-exact; float features are within 1e-3 of JAX (JAX's
CPU chain is the f32 DFT matmul, the JAX stream kernel's own test bound)
and within 5e-4 of the float64 oracle (the float contract), all finite.
"""

import functools
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mfcc_tpu import streaming as jstreaming
from mfcc_tpu.config import MFCCConfig as JaxConfig
from mfcc_tpu.ops import framing as jframing, pallas_stream
from mfcc_tpu.ref import float_ref, int_ref

from mfcc_tpu_torch import MFCC, MFCCConfig, StreamingMFCC, StreamState
from mfcc_tpu_torch import streaming
from mfcc_tpu_torch.ops import framing, stream_fused

CFG = MFCCConfig()
JCFG = JaxConfig()
P = CFG.nfft - 1
TOL_JAX = 1e-3      # float features vs JAX's f32 chain / stream kernel
GATE = 5e-4         # float features vs the float64 oracle


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _signal(S, T, seed, dtype=np.int64):
    rng = np.random.default_rng(seed)
    return rng.integers(-20000, 20000, (S, T)).astype(dtype)


# -- the chunk step ------------------------------------------------------------

def _jax_chunk_step(chunks, state, reset, int_path, lengths):
    if int_path:
        emph = functools.partial(jframing.preemphasis_int, width=16)
        dtype = jnp.int32
    else:
        emph, dtype = jframing.preemphasis, jnp.float32
    return jstreaming._chunk_step_batch(
        jnp.asarray(chunks, dtype), state, jnp.asarray(reset), JCFG, emph,
        dtype, lengths=None if lengths is None else jnp.asarray(lengths))


@pytest.mark.parametrize("int_path", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("C", [1, 149, 600])
def test_chunk_step_batch_matches_jax(int_path, C):
    """Frames, mask and state bit-identical to JAX's ``_chunk_step_batch``
    over 4 steps with a reset of every other stream and flush steps whose
    lengths include out-of-range values (which clip to [0, C])."""
    rng = np.random.default_rng(C)
    S = 3
    ndt, tdt = ((np.int32, torch.int32) if int_path
                else (np.float32, torch.float32))
    jstate = jstreaming.init_state(S, JCFG, jnp.int32 if int_path
                                   else jnp.float32)
    tstate = streaming.init_state(S, CFG, tdt)
    emph = (functools.partial(framing.preemphasis_int, width=16) if int_path
            else framing.preemphasis)
    lengths_at = {1: [C, C // 2, -3], 3: [0, C + 5, 1]}
    for step in range(4):
        x = rng.integers(-25000, 25000, (S, C))
        if not int_path:
            x = x + rng.random((S, C))          # not integer-valued
        x = x.astype(ndt)
        reset = np.zeros(S, bool)
        if step == 2:
            reset[::2] = True
        lengths = lengths_at.get(step)
        jf, jm, jstate = _jax_chunk_step(x, jstate, reset, int_path,
                                         None if lengths is None
                                         else np.array(lengths, np.int32))
        tf, tm, tstate = streaming._chunk_step_batch(
            _t(x), tstate, _t(reset), CFG, emph, tdt,
            None if lengths is None else torch.tensor(lengths))
        assert np.array_equal(tf.numpy(), np.asarray(jf)), step
        assert np.array_equal(tm.numpy(), np.asarray(jm)), step
        for name in StreamState._fields:
            got = getattr(tstate, name).numpy()
            want = np.asarray(getattr(jstate, name))
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (step, name)


def test_align_rows_is_the_barrel_shift():
    x = torch.arange(2 * 20).reshape(2, 20)
    start = torch.tensor([0, 7], dtype=torch.int32)
    want = np.asarray(jstreaming._barrel_align(jnp.asarray(x.numpy()),
                                               jnp.asarray(start.numpy()), 9,
                                               max_start=11))
    assert np.array_equal(framing.align_rows(x, start, 9).numpy(), want)


# -- the plain versions of K4 against the JAX kernels (interpret mode) ----------

def _valid(start, C):
    """Valid frame count of each stream after a full step."""
    total = (P - start) + C
    return np.maximum((total - CFG.nfft) // CFG.hop + 1, 0)


def test_stream_step_int_plain_matches_interpret():
    """K4-INT's plain version equals ``pallas_stream.stream_step_int`` in
    interpret mode on the valid slots, and the carry is equal; stream 2
    gets full-range int32 chunks (emphasis mod 2^32, not mod 2^16).  The
    other layouts give the same integers."""
    rng = np.random.default_rng(5)
    S, C = 3, 600
    buf = rng.integers(-3000, 3000, (S, P)).astype(np.int32)
    chunk = rng.integers(-32768, 32768, (S, C)).astype(np.int32)
    chunk[2] = rng.integers(-2 ** 31, 2 ** 31, C)
    start = np.array([0, 170, 511], np.int32)
    prev = np.array([0, 5, -2 ** 31], np.int32)
    jf, jb = pallas_stream.stream_step_int(
        *(jnp.asarray(a) for a in (buf, chunk, start, prev)), JCFG,
        interpret=True)
    jf, jb = np.asarray(jf), np.asarray(jb)
    args = tuple(_t(a) for a in (buf, chunk, start, prev))
    tf, tb = stream_fused.stream_step_int(*args, CFG)
    assert np.array_equal(tb.numpy(), jb)
    for s, n in enumerate(_valid(start, C)):
        assert n > 0 and np.array_equal(tf.numpy()[s, :n], jf[s, :n]), s
    tf2, tb2 = stream_fused.stream_step_int(
        args[0].T.contiguous(), args[1].T.contiguous(), *args[2:], CFG,
        transposed_state=True, chunk_layout="positions")
    assert torch.equal(tf2, tf) and torch.equal(tb2.T, tb)
    assert tf.shape == (S, stream_fused.frames_per_step(C, CFG), 32)


def test_stream_step_float_plain_matches_interpret():
    """K4-float's plain version is within TOL_JAX of
    ``pallas_stream.stream_step_float`` in interpret mode on the valid
    slots.  Its carry is bit-identical to the JAX kernel's for
    integer-valued input (streams 0, 1).  For input that is not
    integer-valued (stream 2) it is bit-identical to JAX's chunk step: x -
    0.96875*p rounded twice in f32; XLA on the CPU contracts the Pallas
    body's x - c*p into one FMA, which rounds once."""
    rng = np.random.default_rng(6)
    S, C = 3, 600
    buf = rng.integers(-3000, 3000, (S, P)).astype(np.float32)
    chunk = rng.integers(-25000, 25000, (S, C)).astype(np.float32)
    chunk[2] += rng.random(C).astype(np.float32)
    start = np.array([0, 170, 511], np.int32)
    prev = np.array([0.0, 5.0, -7.25], np.float32)
    jf, jb = pallas_stream.stream_step_float(
        *(jnp.asarray(a) for a in (buf, chunk, start, prev)), JCFG,
        interpret=True)
    jf, jb = np.asarray(jf), np.asarray(jb)
    args = tuple(_t(a) for a in (buf, chunk, start, prev))
    tf, tb = stream_fused.stream_step_float(*args, CFG)
    tb = tb.numpy()
    assert np.array_equal(tb[:2], jb[:2])
    # one rounding fewer: half an ulp of c*p (2^-10, |c*p| < 2^15) plus
    # half an ulp of the result (2^-9, |x - c*p| < 2^16), under 2^-8
    assert np.abs(tb[2] - jb[2]).max() <= np.spacing(np.float32(2 ** 15))
    assert not np.array_equal(tb[2], jb[2])   # this input tells them apart
    _, _, jstate = _jax_chunk_step(
        chunk, jstreaming.StreamState(jnp.asarray(buf),
                                      jnp.asarray(P - start),
                                      jnp.asarray(prev)),
        np.zeros(S, bool), False, None)
    assert np.array_equal(tb, np.asarray(jstate.buffer))
    for s, n in enumerate(_valid(start, C)):
        assert n > 0
        got = tf.numpy()[s, :n]
        assert np.isfinite(got).all()
        assert np.abs(got - jf[s, :n]).max() <= TOL_JAX, s


@pytest.mark.parametrize("int_path", [True, False], ids=["int", "float"])
def test_stream_step_layouts_agree(int_path):
    """Every carry and chunk layout gives the same features and carry, and
    an int16 chunk the same as its int32/f32 values."""
    rng = np.random.default_rng(7)
    S, C = 3, 400
    dt = np.int32 if int_path else np.float32
    buf = _t(rng.integers(-3000, 3000, (S, P)).astype(dt))
    chunk = rng.integers(-32768, 32768, (S, C))
    start = torch.tensor([0, 300, 511], dtype=torch.int32)
    prev = torch.tensor([1, -2, 3]).to(buf.dtype)
    step = (stream_fused.stream_step_int if int_path
            else stream_fused.stream_step_float)
    f0, b0 = step(buf, _t(chunk.astype(dt)), start, prev, CFG)
    for layout in stream_fused.LAYOUTS:
        for ts in (False, True):
            x = _t(chunk.astype(np.int16))
            x = x.T.contiguous() if layout == "positions" else x
            b = buf.T.contiguous() if ts else buf
            f, nb = step(b, x, start, prev, CFG, transposed_state=ts,
                         chunk_layout=layout)
            assert torch.equal(f, f0), (layout, ts)
            assert torch.equal(nb.T if ts else nb, b0), (layout, ts)


def test_stream_step_checks():
    buf = torch.zeros(2, P)
    x = torch.zeros(2, 300)
    start = torch.zeros(2, dtype=torch.int32)
    prev = torch.zeros(2)
    with pytest.raises(TypeError, match="chunk"):
        stream_fused.stream_step_float(buf, x.double(), start, prev)
    with pytest.raises(TypeError, match="carry"):
        stream_fused.stream_step_int(buf, x.int(), start, prev.int())
    with pytest.raises(TypeError, match="start"):
        stream_fused.stream_step_float(buf, x, start.long(), prev)
    with pytest.raises(ValueError, match="do not fit"):
        stream_fused.stream_step_float(buf[:, :100], x, start, prev)
    with pytest.raises(ValueError, match="streams"):
        stream_fused.stream_step_float(buf, x, start[:1], prev)
    with pytest.raises(ValueError, match="chunk_layout"):
        stream_fused.stream_step_float(buf, x, start, prev,
                                       chunk_layout="rows")
    with pytest.raises(ValueError, match="family"):
        stream_fused.stream_step_float(buf, x, start, prev,
                                       MFCCConfig(step=171))
    before = dict(stream_fused.LAUNCHES)
    stream_fused.stream_step_float(buf, x, start, prev)
    assert stream_fused.LAUNCHES == before        # the CPU never launches


# -- StreamingMFCC against the JAX package and the oracles ---------------------

def test_process_int_matches_jax_and_oracle():
    sig = _signal(3, 1500, seed=1)
    got, state = StreamingMFCC(int_path=True, device="cpu").process(sig, 149)
    want, jstate = jstreaming.StreamingMFCC(JCFG, int_path=True).process(
        sig, 149)
    for s in range(3):
        assert np.array_equal(got[s], want[s]), s
        assert np.array_equal(got[s], int_ref.mfcc_int(sig[s], JCFG)), s
    for name in StreamState._fields:
        assert np.array_equal(getattr(state, name).numpy(),
                              np.asarray(getattr(jstate, name))), name


def test_process_float_matches_jax_and_oracle():
    sig = _signal(3, 1500, seed=2).astype(np.float32)
    got, state = StreamingMFCC(device="cpu").process(sig, 149)
    want, jstate = jstreaming.StreamingMFCC(JCFG).process(sig, 149)
    for s in range(3):
        assert np.isfinite(got[s]).all()
        assert got[s].shape == want[s].shape == (CFG.n_frames(1500), 32)
        assert np.abs(got[s] - want[s]).max() <= TOL_JAX, s
        assert np.abs(got[s] - float_ref.mfcc_float(sig[s])).max() <= GATE
    for name in StreamState._fields:
        assert np.array_equal(getattr(state, name).numpy(),
                              np.asarray(getattr(jstate, name))), name


@pytest.mark.parametrize("C", [1, 149, 600])
def test_process_equals_batch(C):
    """Any chunking equals the batch path on the same signal (the port's own
    ``MFCC(device="cpu")``): INT element-exact, float within 5e-5 (both
    compute the tail in float64 from the same f32 emphasis; the final
    partial chunk's frames take the f32 chain, as in JAX)."""
    sig = _signal(2, 900 if C == 1 else 1500, seed=C)
    fe = MFCC(device="cpu")
    got, _ = StreamingMFCC(int_path=True, device="cpu").process(sig, C)
    want = fe.int(sig).numpy()
    for s in range(2):
        assert np.array_equal(got[s], want[s])
    got, _ = StreamingMFCC(device="cpu").process(sig, C)
    want = fe(sig.astype(np.float32)).numpy()
    full = CFG.n_frames((sig.shape[1] // C) * C)      # frames of full steps
    for s in range(2):
        assert got[s].shape == want[s].shape
        assert np.abs(got[s][:full] - want[s][:full]).max() <= 5e-5
        assert np.abs(got[s] - want[s]).max() <= TOL_JAX


# -- the twins of tests/test_streaming.py and tests/test_streaming_fuzz.py --------

def _batch_float(sig):
    return MFCC(device="cpu")(torch.as_tensor(sig, dtype=torch.float32)
                              ).numpy()


def test_streaming_equals_batch_float(audio_int16):
    want = _batch_float(audio_int16)
    outs, _ = StreamingMFCC(device="cpu").process(
        audio_int16[None, :].repeat(2, 0), chunk_size=149)
    for s in range(2):
        assert outs[s].shape == want.shape
        assert np.abs(outs[s] - want).max() < 1e-3


def test_streaming_equals_batch_int(audio_int16):
    sig = audio_int16.astype(np.int64)
    want = int_ref.mfcc_int(sig, JCFG)
    outs, _ = StreamingMFCC(int_path=True, device="cpu").process(
        sig[None, :], chunk_size=298)
    assert np.array_equal(outs[0], want)


def test_reset_protocol(audio_int16):
    """A reset flag mid-stream restarts framing exactly as a fresh stream."""
    sig = audio_int16
    sm = StreamingMFCC(device="cpu")
    C = 298
    state = sm.init(1)
    nchunks = len(sig) // C
    collected = []
    for ci in range(nchunks):
        feats, mask, state = sm.step(sig[None, ci * C:(ci + 1) * C], state,
                                     np.array([ci == 2]))
        collected.append(feats[0][mask[0]].numpy())
    got_after = np.concatenate(collected[2:])
    want = _batch_float(sig[2 * C: nchunks * C])
    assert got_after.shape == want.shape
    assert np.abs(got_after - want).max() < 1e-3


def test_streaming_chunkings_agree(audio_int16):
    sig = audio_int16.astype(np.int64)
    sm = StreamingMFCC(int_path=True, device="cpu")
    a, _ = sm.process(sig[None, :1100], chunk_size=100)
    b, _ = sm.process(sig[None, :1100], chunk_size=550)
    assert np.array_equal(a[0], b[0])


def test_process_consumes_tail(audio_int16):
    sig = audio_int16.astype(np.int64)          # 1192 samples
    want = int_ref.mfcc_int(sig, JCFG)          # 5 frames
    outs, state = StreamingMFCC(int_path=True, device="cpu").process(
        sig[None, :], chunk_size=500)
    assert np.array_equal(outs[0], want)
    assert int(state.count[0]) == 1192 - want.shape[0] * CFG.hop


def test_lengths_padding_is_inert(audio_int16):
    """A length-limited chunk equals feeding the short chunk alone: padding
    never reaches the carry or a valid frame."""
    sig = audio_int16.astype(np.int64)
    sm = StreamingMFCC(int_path=True, device="cpu")
    s1 = sm.init(1)
    f1, m1, s1 = sm.step(sig[None, :700], s1)
    f1b, m1b, s1 = sm.step(sig[None, 700:1192], s1)
    s2 = sm.init(1)
    g1, n1, s2 = sm.step(sig[None, :700], s2)
    padded = np.full((1, 700), 12345, np.int64)
    padded[0, :492] = sig[700:1192]
    g2, n2, s2 = sm.step(padded, s2, lengths=np.array([492]))
    a = torch.cat([f1[0][m1[0]], f1b[0][m1b[0]]])
    b = torch.cat([g1[0][n1[0]], g2[0][n2[0]]])
    assert torch.equal(a, b)
    n = int(s1.count[0])
    assert int(s2.count[0]) == n and int(s2.prev[0]) == int(s1.prev[0])
    assert torch.equal(s1.buffer[0, -n:], s2.buffer[0, -n:])


def test_drain_flushes_partial_frames(audio_int16):
    sig = audio_int16.astype(np.int64)
    sm = StreamingMFCC(int_path=True, device="cpu")
    outs, _ = sm.process(sig[None, :], chunk_size=298, drain=True)
    want_all = int_ref.mfcc_int(np.concatenate([sig, np.zeros(512, np.int64)]),
                                JCFG)
    n_real = sum(1 for k in range(want_all.shape[0]) if k * CFG.hop < len(sig))
    assert np.array_equal(outs[0], want_all[:n_real])
    assert n_real > int_ref.mfcc_int(sig, JCFG).shape[0]
    _, mask, _ = sm.drain(sm.init(1))
    assert not mask.any()


def test_state_is_checkpointable(audio_int16):
    sig = audio_int16
    sm = StreamingMFCC(device="cpu")
    C = 298
    state = sm.init(1)
    feats = []
    for ci in range(2):
        f, m, state = sm.step(sig[None, ci * C:(ci + 1) * C], state)
        feats.append(f[0][m[0]].numpy())
    state2 = StreamState.from_numpy(
        {k: getattr(state, k).numpy().copy() for k in StreamState._fields},
        "cpu")
    for ci in range(2, 4):
        f, m, state2 = sm.step(sig[None, ci * C:(ci + 1) * C], state2)
        feats.append(f[0][m[0]].numpy())
    got = np.concatenate(feats)
    want = _batch_float(sig[: 4 * C])
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-3


def test_fuzz_chunkings_and_resets(audio_int16):
    """Three streams, adversarial reset schedule, INT path (exact)."""
    C = 173
    sig = np.concatenate([audio_int16, audio_int16])[: C * 12]
    sm = StreamingMFCC(int_path=True, device="cpu")
    S = 3
    batch = np.stack([sig, sig[::-1].copy(), np.roll(sig, 7)])
    state = sm.init(S)
    schedule = {4: np.array([False, True, False]),
                9: np.array([False, False, True])}
    outs = [[] for _ in range(S)]
    nchunks = len(sig) // C
    reset_points = {1: 4 * C, 2: 9 * C}
    for ci in range(nchunks):
        feats, mask, state = sm.step(
            batch[:, ci * C:(ci + 1) * C].astype(np.int64), state,
            schedule.get(ci))
        for s in range(S):
            outs[s].append(feats[s][mask[s]].numpy())
    for s in range(S):
        got = np.concatenate(outs[s])
        start = reset_points.get(s, 0)
        want = int_ref.mfcc_int(batch[s, start: nchunks * C]
                                .astype(np.int64), JCFG)
        assert want.shape[0] > 0
        assert np.array_equal(got[-want.shape[0]:], want), s


class TestSilenceContract:
    """The float-path silence contract: the default keeps the notebook
    spec (log2(0) = -inf); ``mel_floor=1.0`` makes silence finite."""

    def _silent_step(self, **kw):
        sm = StreamingMFCC(device="cpu", **kw)
        f, m, _ = sm.step(torch.zeros(1, 852), sm.init(1))
        return f[0][m[0]].numpy()

    def test_default_float_silence_is_nonfinite_by_spec(self):
        feats = self._silent_step()
        assert feats.shape[0] == 3
        assert not np.isfinite(feats).all()

    def test_mel_floor_makes_silence_finite(self):
        feats = self._silent_step(mel_floor=1.0)
        assert feats.shape[0] == 3
        assert np.isfinite(feats).all()
        assert np.abs(feats).max() == 0.0

    def test_mel_floor_is_inert_on_loud_audio(self):
        rng = np.random.default_rng(3)
        sig = rng.integers(-8000, 8000, 1192).astype(np.float32)
        want = _batch_float(sig)
        outs, _ = StreamingMFCC(device="cpu", mel_floor=1.0).process(
            sig[None, :], chunk_size=298)
        assert np.abs(outs[0] - want[: outs[0].shape[0]]).max() < 1e-3

    def test_int_path_silence_is_zero(self):
        sm = StreamingMFCC(int_path=True, device="cpu")
        f, m, _ = sm.step(torch.zeros(1, 852, dtype=torch.int32), sm.init(1))
        feats = f[0][m[0]]
        assert feats.shape[0] == 3
        assert not feats.any()


# -- layouts, routes, checkpoints, devices -------------------------------------

@pytest.mark.parametrize("int_path", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("ts,tc", [(False, True), (True, False), (True, True)])
def test_transposed_layouts_agree(int_path, ts, tc):
    sig = _signal(2, 1192, seed=9)
    want, wstate = StreamingMFCC(int_path=int_path, device="cpu").process(
        sig, 298, drain=True)
    got, state = StreamingMFCC(int_path=int_path, device="cpu",
                               transposed_state=ts,
                               transposed_chunks=tc).process(sig, 298,
                                                             drain=True)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    buf = state.buffer.T if ts else state.buffer
    assert torch.equal(buf, wstate.buffer)


@pytest.mark.parametrize("kw,route", [
    (dict(int_path=True), "fused"),
    ({}, "fused"),
    (dict(precision="fast"), "split"),
    (dict(method="rfft"), "chain"),
    (dict(dtype=torch.float64), "chain"),
    (dict(cfg=MFCCConfig(step=171)), "chain"),
    (dict(cfg=MFCCConfig(step=171), int_path=True), "chain"),
    (dict(cfg=MFCCConfig(nfft=256, step=86)), "chain"),
])
def test_routes_mirror_jax(kw, route):
    """Full-chunk steps go to K4 where the JAX package runs its fused step
    (the split-DFT step for ``precision="fast"`` off the CPU); every route
    computes on the CPU and matches the oracle."""
    sm = StreamingMFCC(device="cpu", **kw)
    assert sm._route == route
    cfg = kw.get("cfg", CFG)
    sig = _signal(1, 1500, seed=4)
    got, _ = sm.process(sig, 400)
    if kw.get("int_path"):
        assert np.array_equal(got[0], int_ref.mfcc_int(sig[0], JaxConfig(
            nfft=cfg.nfft, step=cfg.step)))
    else:
        want = float_ref.mfcc_float(sig[0].astype(np.float32), JaxConfig(
            nfft=cfg.nfft, step=cfg.step))
        assert np.abs(got[0] - want).max() <= GATE


def test_fast_precision_raises_off_the_cpu(monkeypatch):
    """precision="fast": a full step on any device but the CPU goes to the
    split-DFT step at 3 passes (here the meta device stands in for the
    card, and the wrapper raises for it, as it does for any tensor that is
    neither CUDA nor CPU); the CPU takes the "highest" chain and never
    launches."""
    sm = StreamingMFCC(precision="fast", device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU tensors, got meta"):
        sm.step(torch.zeros(2, 1024, device="meta"), sm.init(2))
    seen = []
    monkeypatch.setattr(stream_fused, "stream_step_float",
                        lambda *a, **k: seen.append(k["dft_passes"])
                        or (torch.zeros(2, 7, 32, device="meta"), a[0]))
    sm.step(torch.zeros(2, 1024, device="meta"), sm.init(2))
    assert seen == [3]
    monkeypatch.undo()
    cpu = StreamingMFCC(precision="fast", device="cpu")
    before = dict(stream_fused.LAUNCHES)
    x = torch.from_numpy(_signal(2, 1024, seed=3).astype(np.float32))
    f, m, _ = cpu.step(x, cpu.init(2))
    assert f.shape == (2, 7, 32)
    want, _, _ = StreamingMFCC(device="cpu")._chain_step(
        x, cpu.init(2), torch.zeros(2, dtype=torch.bool), None)
    assert torch.equal(f, want)
    assert stream_fused.LAUNCHES == before


@pytest.mark.parametrize("precision", ["high", "default", "bf16"])
def test_unported_precision_raises(precision):
    with pytest.raises(NotImplementedError, match="not ported"):
        StreamingMFCC(precision=precision, device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        StreamingMFCC()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        streaming.load_state("nowhere.npz")


def test_input_on_another_device_raises():
    sm = StreamingMFCC(device="cpu")
    with pytest.raises(ValueError, match="meta.*cpu"):
        sm.step(torch.zeros(1, 600, device="meta"), sm.init(1))


@pytest.mark.parametrize("int_path", [True, False], ids=["int", "float"])
def test_jax_checkpoint_resumes_in_the_port(int_path, tmp_path, monkeypatch):
    """A carry saved by the JAX package (its npz format: orbax made
    unimportable) and loaded by ``load_state`` continues exactly as JAX
    continues; the port's own save/load round-trips."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    sig = _signal(2, 1700, seed=10)
    C = 340
    jsm = jstreaming.StreamingMFCC(JCFG, int_path=int_path)
    jstate = jsm.init(2)
    for ci in range(2):
        _, _, jstate = jsm.step(sig[:, ci * C:(ci + 1) * C], jstate)
    path = str(tmp_path / "carry")
    jstreaming.save_state(path, jstate)
    state = streaming.load_state(path + ".npz", device="cpu")
    sm = StreamingMFCC(int_path=int_path, device="cpu")
    for ci in range(2, 5):
        chunk = sig[:, ci * C:(ci + 1) * C]
        jf, jm, jstate = jsm.step(chunk, jstate)
        tf, tm, state = sm.step(chunk, state)
        jm = np.asarray(jm)
        assert np.array_equal(tm.numpy(), jm)
        if int_path:
            assert np.array_equal(tf.numpy()[tm.numpy()], np.asarray(jf)[jm])
        else:
            assert np.abs(tf.numpy()[jm] - np.asarray(jf)[jm]).max() \
                <= TOL_JAX
        for name in StreamState._fields:
            assert np.array_equal(getattr(state, name).numpy(),
                                  np.asarray(getattr(jstate, name))), name
    streaming.save_state(str(tmp_path / "port"), state)
    again = streaming.load_state(str(tmp_path / "port"), device="cpu")
    for a, b in zip(again, state):
        assert a.dtype == b.dtype and torch.equal(a, b)
