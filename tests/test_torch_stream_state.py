"""The serving step's step-level entries on the CPU: the plain versions of
``stream_fused.stream_step_float_state`` / ``stream_step_int_state`` (the
whole full-chunk ``StreamingMFCC`` step, reset merge and state update
included, that K4's kernels run in one launch on the card) and
``StreamingMFCC.step`` through them, against the JAX package's
``mfcc_tpu.streaming.StreamingMFCC.step`` on the same numpy inputs.

Tolerances: INT features, and for both paths the mask, the carry, the
count and the prev, are element-exact; float features on the valid frame
slots are within 5e-5 of JAX's (JAX's CPU step is its f32 chain, the
port's plain version K1's tail in float64) and finite.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mfcc_tpu import streaming as jstreaming
from mfcc_tpu.config import MFCCConfig as JaxConfig

from mfcc_tpu_torch import MFCCConfig, StreamingMFCC, StreamState
from mfcc_tpu_torch.ops import stream_fused

CFG = MFCCConfig()
JCFG = JaxConfig()
P = CFG.nfft - 1
TOL = 5e-5          # float features vs JAX's step on the valid slots
WIDTHS = [1, 169, 170, 171, 600, 1024, 2048]
# (transposed_state, transposed_chunks) of the port's streams
LAYOUTS = [(False, False), (True, False), (False, True), (True, True)]


# The last step's float chunk is not integer-valued.  There JAX's jitted
# step reads x - 0.96875 * p as one FMA (XLA on the CPU contracts it, one
# rounding), where the port rounds twice, as JAX's step does op by op
# (``test_chunk_step_batch_matches_jax``): that carry is held within the
# one rounding's bound, half an ulp of c*p plus half an ulp of the result
# (|c*p| < 2^15, |x - c*p| < 2^16), under 2^-8.
FMA_BOUND = float(np.spacing(np.float32(2 ** 15)))


def _chunk(rng, int_path, S, C, k):
    """Step k's chunk: int16 on even steps; on odd ones the state dtype,
    full-range int32 for INT, integer values for float and, on step 3,
    values that are not integers."""
    if k % 2 == 0:
        return rng.integers(-32768, 32768, (S, C)).astype(np.int16)
    if int_path:
        return rng.integers(-2 ** 31, 2 ** 31, (S, C)).astype(np.int32)
    x = rng.integers(-25000, 25000, (S, C)).astype(np.float32)
    return x + rng.random((S, C)).astype(np.float32) if k == 3 else x


def _jax_chunk(x, int_path):
    return jnp.asarray(x.astype(np.int32 if int_path else np.float32))


def _state_np(st, transposed_state=False):
    buf = st.buffer.T if transposed_state else st.buffer
    return [np.asarray(buf), np.asarray(st.count), np.asarray(st.prev)]


def _assert_step(got, want, int_path, what, carry_tol=0.0):
    """got/want: (feats, mask, [buffer, count, prev]) as numpy; the carry
    within ``carry_tol`` (0: equal)."""
    (gf, gm, gs), (wf, wm, ws) = got, want
    assert gm.dtype == np.bool_ and np.array_equal(gm, wm), what
    for name, g, w in zip(StreamState._fields, gs, ws):
        assert g.dtype == w.dtype, (what, name)
        if name == "buffer" and carry_tol:
            assert np.abs(g - w).max() <= carry_tol, (what, name)
        else:
            assert np.array_equal(g, w), (what, name)
    assert gf.shape == wf.shape, what
    if int_path:
        assert gf.dtype == np.int32 and np.array_equal(gf, wf), what
    else:
        assert np.isfinite(gf[gm]).all(), what
        err = np.abs(gf[gm] - wf[gm]).max() if gm.any() else 0.0
        assert err <= TOL, (what, err)


@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("int_path", [True, False], ids=["int", "float"])
def test_state_step_plain_matches_jax(int_path, C):
    """Four steps of 5 streams with random reset patterns: the step-level
    plain version (every carry and chunk layout) and ``StreamingMFCC.step``
    on the CPU in the four (transposed_state, transposed_chunks) settings,
    each with its own state threaded through, equal JAX's
    ``StreamingMFCC.step`` in features, mask, carry, count and prev (the
    carry after the float step on values that are not integers within
    ``FMA_BOUND``)."""
    rng = np.random.default_rng(C + 7 * int_path)
    S = 5
    jsm = jstreaming.StreamingMFCC(JCFG, int_path=int_path)
    jst = jsm.init(S)
    sms = [StreamingMFCC(int_path=int_path, device="cpu",
                         transposed_state=ts, transposed_chunks=tc)
           for ts, tc in LAYOUTS]
    sts = [sm.init(S) for sm in sms]
    plain = (stream_fused.stream_step_int_state_plain if int_path
             else stream_fused.stream_step_float_state_plain)
    for k in range(4):
        x = _chunk(rng, int_path, S, C, k)
        reset = rng.random(S) < 0.4 if k else np.zeros(S, bool)
        before = _state_np(jst)
        jf, jm, jst = jsm.step(_jax_chunk(x, int_path), jst,
                               reset=jnp.asarray(reset))
        want = (np.asarray(jf), np.asarray(jm), _state_np(jst))
        for (ts, tc), sm, i in zip(LAYOUTS, sms, range(len(sms))):
            xin = torch.from_numpy(np.ascontiguousarray(x.T if tc else x))
            f, m, sts[i] = sm.step(xin, sts[i], reset=torch.from_numpy(reset))
            tol = FMA_BOUND if x.dtype == np.float32 and k == 3 else 0.0
            _assert_step((f.numpy(), m.numpy(), _state_np(sts[i], ts)), want,
                         int_path, (k, "StreamingMFCC", ts, tc), tol)
            # the plain version from the state before the step, in this
            # layout, with the reset given (or None where no stream resets)
            buf = torch.from_numpy(before[0].copy())
            out = plain(buf.T.contiguous() if ts else buf, xin,
                        torch.from_numpy(before[1].copy()),
                        torch.from_numpy(before[2].copy()),
                        torch.from_numpy(reset) if reset.any() else None,
                        CFG, transposed_state=ts,
                        chunk_layout="positions" if tc else "time")
            nb = out[2].T if ts else out[2]
            _assert_step((out[0].numpy(), out[1].numpy(),
                          [nb.numpy(), out[3].numpy(), out[4].numpy()]),
                         want, int_path, (k, "plain", ts, tc), tol)


# count + C - windowlen over the counts 0 .. P: at C = 170 and 171 it runs
# over [-342, 169] and [-341, 170], each holding all of (-170, 0) and every
# residue mod 170; at C = 1 over [-511, 0]
FLOOR_WIDTHS = [1, 170, 171]


@pytest.mark.parametrize("C", FLOOR_WIDTHS)
@pytest.mark.parametrize("int_path", [True, False], ids=["int", "float"])
def test_state_step_floor_division_matches_jax(int_path, C):
    """One step of 512 streams whose counts are 0 .. 511 and 64 more
    streams with random counts, of which a random half are reset, the
    state made directly (random carries and prevs): count + C - 512 lands
    in (-170, 0), where C++'s truncating division would give one valid
    frame too many, and in every residue mod 170; the plain version's mask
    and new count (and everything else) equal JAX's, and its count of
    valid frames is the floor division's."""
    rng = np.random.default_rng(C)
    count = np.concatenate([np.arange(P + 1), rng.integers(0, P + 1, 64)]
                           ).astype(np.int32)
    S = len(count)
    reset = np.zeros(S, bool)
    reset[P + 1:] = rng.random(64) < 0.5
    d = count[~reset] + C - CFG.windowlen
    if C > 1:
        assert set(range(-CFG.hop + 1, 0)) <= set(d.tolist())
        assert set((d % CFG.hop).tolist()) == set(range(CFG.hop))
    else:
        assert d.max() == 0 and (d > -CFG.hop).sum() >= CFG.hop
    dt = np.int32 if int_path else np.float32
    buf = rng.integers(-3000, 3000, (S, P)).astype(dt)
    prev = rng.integers(-3000, 3000, S).astype(dt)
    x = rng.integers(-32768, 32768, (S, C)).astype(np.int16)
    jsm = jstreaming.StreamingMFCC(JCFG, int_path=int_path)
    jst = jstreaming.StreamState(jnp.asarray(buf), jnp.asarray(count),
                                 jnp.asarray(prev))
    jf, jm, jst = jsm.step(_jax_chunk(x, int_path), jst,
                           reset=jnp.asarray(reset))
    want = (np.asarray(jf), np.asarray(jm), _state_np(jst))
    plain = (stream_fused.stream_step_int_state_plain if int_path
             else stream_fused.stream_step_float_state_plain)
    out = plain(torch.from_numpy(buf), torch.from_numpy(x),
                torch.from_numpy(count), torch.from_numpy(prev),
                torch.from_numpy(reset), CFG)
    got = (out[0].numpy(), out[1].numpy(), [o.numpy() for o in out[2:]])
    _assert_step(got, want, int_path, "floor")
    total = np.where(reset, 0, count) + C
    n_valid = np.maximum((total - CFG.windowlen) // CFG.hop + 1, 0)
    assert np.array_equal(got[1].sum(axis=1), n_valid)
    assert np.array_equal(got[2][1], total - n_valid * CFG.hop)


def test_state_step_entries_check_and_route(monkeypatch):
    """The step-level entries check their state operands (count int32 of
    shape (S,), reset bool (S,)), run their plain versions on CPU tensors
    without a launch, refuse configs outside their kernels' family, and
    ``StreamingMFCC`` sends a full step without a reset through them with
    ``reset`` None."""
    buf = torch.zeros(2, P)
    x = torch.zeros(2, 300, dtype=torch.int16)
    count = torch.zeros(2, dtype=torch.int32)
    prev = torch.zeros(2)
    step = stream_fused.stream_step_float_state
    with pytest.raises(TypeError, match="count"):
        step(buf, x, count.long(), prev)
    with pytest.raises(TypeError, match="reset"):
        step(buf, x, count, prev, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="reset"):
        step(buf, x, count, prev, torch.zeros(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="family"):
        step(buf, x, count, prev, cfg=MFCCConfig(step=171))
    with pytest.raises(TypeError, match="carry"):
        stream_fused.stream_step_int_state(buf, x, count, prev.int())
    before = dict(stream_fused.LAUNCHES)
    staged = dict(stream_fused.STAGED_LAUNCHES)
    f, m, nb, nc, npv = step(buf, x, count, prev)
    assert stream_fused.LAUNCHES == before
    assert stream_fused.STAGED_LAUNCHES == staged
    assert f.shape == (2, 2, 32) and m.dtype == torch.bool
    assert nc.dtype == torch.int32 and npv.dtype == torch.float32
    seen = []

    def spy(*a, **k):
        seen.append(a[4])
        return step(*a, **k)

    monkeypatch.setattr(stream_fused, "stream_step_float_state", spy)
    sm = StreamingMFCC(device="cpu")
    sm.step(x, sm.init(2))
    sm.step(x, sm.init(2), reset=[True, False])
    assert seen[0] is None
    assert torch.equal(seen[1], torch.tensor([True, False]))
