"""The torch package's K8 entry points (``ops/dense_fused.py``) on the CPU,
through their plain versions, against the JAX package's dense-DFT Pallas
kernels (``pallas_mfcc``) run in interpret mode and against the float64
oracle, on the same numpy inputs.

The JAX kernels take no ``interpret`` argument (but fmaj), so the
``interpret`` fixture swaps ``pl.pallas_call`` for one that forces
``interpret=True`` for the test's duration; the JAX package is not edited.

Tolerances, each with its reason:

  * plain version vs JAX kernel: 5e-5 (``KERNEL_TOL``).  Both take the same
    f32 frames and the same bf16 limbs; the port sums the exact products in
    float64, the JAX kernel in f32 (measured <= 1.6e-5 on these inputs).
  * non-integer f32 input to the in-kernel emphasis (recomp, fmaj): 5e-5,
    measured 1.5e-5: the emphasis is rounded twice in both.
  * vs the float64 oracle: 5e-4 for the f32-operand entries and raw on the
    test input; for the split entries 5e-4 on the JAX bench's gate input
    (``make_audio(2, 1192, seed=7)``) and, on the longer test input, 1.1x
    the JAX kernel's own reading (the bf16 limbs of emphasized samples
    lose bits: both read 7.6e-4 here).
"""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

from mfcc_tpu.config import MFCCConfig as JaxConfig
from mfcc_tpu.ops import pallas_mfcc
from mfcc_tpu.ref import float_ref

from mfcc_tpu_torch import MFCCConfig
from mfcc_tpu_torch.ops import dense_fused, framing

KERNEL_TOL = 5e-5
GATE = 5e-4
HOPS = {256: 86, 512: 170, 1024: 340}


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pl.pallas_call`` of the test runs in interpret mode."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _noise(S, n_frames, nfft=512, hop=170, seed=0):
    """(S, T) int16 noise, normal x 3000, of ``n_frames`` frames."""
    rng = np.random.default_rng(seed)
    T = nfft + (n_frames - 1) * hop
    return np.clip(rng.normal(0, 3000, (S, T)), -32768, 32767).astype(np.int16)


def _make_audio(S, T, seed=0):
    """The JAX bench's signal (``bench.make_audio``): integer-valued f32."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000.0
    base = (9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
            + 4000 * np.sin(2 * np.pi * 900 * t))
    noise = rng.integers(-1500, 1500, (S, T))
    return np.round(np.clip(base[None, :] + noise,
                            -32768, 32767)).astype(np.float32)


def _jcfg(cfg):
    return JaxConfig(nfft=cfg.nfft, step=cfg.step)


def _oracle(sig, cfg):
    return np.stack([float_ref.mfcc_float(s, _jcfg(cfg)) for s in sig])


def _emph(x):
    """The f32 emphasis, rounded twice, as numpy f32."""
    return framing.preemphasis(torch.from_numpy(x.astype(np.float32))).numpy()


# (name, JAX entry on numpy input, port entry, port plain, split)
ENTRIES = {
    "emphasized": (lambda x, c: pallas_mfcc.mfcc_pallas_emphasized(
        jnp.asarray(_emph(x)), c),
        lambda x, c: dense_fused.mfcc_emphasized(torch.from_numpy(_emph(x)), c),
        lambda x, c: dense_fused.mfcc_emphasized_plain(
            torch.from_numpy(_emph(x)), c), False),
    "emphasized split": (lambda x, c: pallas_mfcc.mfcc_pallas_emphasized(
        jnp.asarray(_emph(x)), c, split=True),
        lambda x, c: dense_fused.mfcc_emphasized(torch.from_numpy(_emph(x)), c,
                                                 split=True),
        lambda x, c: dense_fused.mfcc_emphasized_plain(
            torch.from_numpy(_emph(x)), c, split=True), True),
    "batch": (lambda x, c: pallas_mfcc.mfcc_batch_pallas(
        jnp.asarray(x, jnp.float32), c),
        lambda x, c: dense_fused.mfcc_batch_dense(torch.from_numpy(x), c),
        lambda x, c: dense_fused.mfcc_batch_dense_plain(torch.from_numpy(x), c),
        False),
    "raw": (lambda x, c: pallas_mfcc.mfcc_pallas_raw(
        jnp.asarray(x, jnp.float32), c),
        lambda x, c: dense_fused.mfcc_raw(torch.from_numpy(x), c),
        lambda x, c: dense_fused.mfcc_raw_plain(torch.from_numpy(x), c), True),
    "aligned": (lambda x, c: pallas_mfcc.mfcc_pallas_aligned(
        jnp.asarray(x, jnp.float32), c),
        lambda x, c: dense_fused.mfcc_aligned(torch.from_numpy(x), c),
        lambda x, c: dense_fused.mfcc_aligned_plain(torch.from_numpy(x), c),
        True),
    "recomp": (lambda x, c: pallas_mfcc.mfcc_pallas_recomp(
        jnp.asarray(x, jnp.float32), c),
        lambda x, c: dense_fused.mfcc_recomp(torch.from_numpy(x), c),
        lambda x, c: dense_fused.mfcc_recomp_plain(torch.from_numpy(x), c),
        True),
    "seg": (lambda x, c: pallas_mfcc.mfcc_pallas_seg(
        jnp.asarray(x, jnp.float32), c),
        lambda x, c: dense_fused.mfcc_seg(torch.from_numpy(x), c),
        lambda x, c: dense_fused.mfcc_seg_plain(torch.from_numpy(x), c), True),
    "fmaj": (lambda x, c: pallas_mfcc.mfcc_pallas_fmaj(jnp.asarray(x), c),
             lambda x, c: dense_fused.mfcc_fmaj(torch.from_numpy(x), c),
             lambda x, c: dense_fused.mfcc_fmaj_plain(torch.from_numpy(x), c),
             False),
}


@functools.lru_cache(maxsize=None)
def _test_input():
    """1 stream x 60 frames of int16 noise (one JAX block, 16 ms of the
    aligned kernel's 512-frame block) and its oracle."""
    x = _noise(1, 60)
    return x, _oracle(x.astype(np.float32), MFCCConfig())


@pytest.mark.parametrize("name", list(ENTRIES))
def test_plain_matches_jax_kernel(interpret, name):
    """Each entry's plain version against its JAX kernel in interpret mode
    (KERNEL_TOL), the CPU wrapper equal to the plain version without a
    launch, and the oracle reading: <= GATE for the f32-operand entries and
    raw; <= 1.1x the JAX kernel's own reading for the split entries."""
    jax_fn, entry, plain, split = ENTRIES[name]
    cfg = MFCCConfig()
    x, oracle = _test_input()
    want = np.asarray(jax_fn(x, _jcfg(cfg)))
    got = plain(x, cfg).numpy()
    assert got.shape == want.shape == oracle.shape
    assert np.abs(got - want).max() <= KERNEL_TOL, name
    before = dict(dense_fused.LAUNCHES)
    assert torch.equal(entry(x, cfg), torch.from_numpy(got))
    assert dense_fused.LAUNCHES == before
    err, jax_err = np.abs(got - oracle).max(), np.abs(want - oracle).max()
    if split and name != "raw":
        assert err <= 1.1 * jax_err, (name, err, jax_err)
    else:
        assert err <= GATE, (name, err)


@pytest.mark.parametrize("name", [n for n, e in ENTRIES.items() if e[3]])
def test_split_entries_hold_the_gate_on_the_gate_input(name):
    """On the JAX bench's gate input the split entries hold 5e-4, as the
    JAX kernels do there."""
    cfg = MFCCConfig()
    sig = _make_audio(2, 512 + 4 * 170, seed=7)
    got = ENTRIES[name][2](sig.astype(np.int16), cfg).numpy()
    err = np.abs(got - _oracle(sig, cfg)).max()
    assert np.isfinite(got).all() and err <= GATE, (name, err)


@pytest.mark.parametrize("name,tol", [("recomp", 2e-4), ("fmaj", KERNEL_TOL)])
def test_in_kernel_emphasis_on_non_integer_f32(interpret, name, tol):
    """Non-integer f32 samples through the in-kernel f32 emphasis.  JAX's
    interpreter contracts x - 0.96875*p into one FMA, the port rounds
    twice: ~1/3 of the emphasized values are an ulp apart, which the split
    limbs of recomp carry to 8.3e-5 in the cepstra (measured; 1.5e-5
    without split), hence recomp's stated 2e-4.  The FMA-emphasized frames
    through the port's emphasized ingest are JAX's within KERNEL_TOL."""
    jax_fn, _, plain, split = ENTRIES[name]
    cfg = MFCCConfig()
    rng = np.random.default_rng(3)
    x = (rng.normal(0, 3000, (1, 512 + 29 * 170))
         + rng.random((1, 512 + 29 * 170))).astype(np.float32)
    want = np.asarray(jax_fn(x, _jcfg(cfg)))
    assert np.abs(plain(x, cfg).numpy() - want).max() <= tol
    prev = np.concatenate([np.zeros((1, 1)), x[:, :-1]], axis=1)
    fma = (x.astype(np.float64) - 0.96875 * prev).astype(np.float32)
    got = dense_fused.mfcc_emphasized_plain(torch.from_numpy(fma), cfg,
                                            split=split).numpy()
    assert np.abs(got - want).max() <= KERNEL_TOL


@pytest.mark.parametrize("nfft", [256, 1024])
@pytest.mark.parametrize("name", ["fmaj", "recomp"])
def test_other_nfft_match_jax(interpret, nfft, name):
    """nfft 256/86 and 1024/340 (HIGHEST and split) against the JAX kernels
    and the oracle (HIGHEST within GATE)."""
    cfg = MFCCConfig(nfft=nfft, step=HOPS[nfft])
    x = _noise(1, 20, nfft, HOPS[nfft], seed=nfft)
    want = np.asarray(ENTRIES[name][0](x, _jcfg(cfg)))
    got = ENTRIES[name][2](x, cfg).numpy()
    assert np.abs(got - want).max() <= KERNEL_TOL
    if name == "fmaj":
        assert np.abs(got - _oracle(x.astype(np.float32), cfg)).max() <= GATE


def test_fmaj_silence_and_mel_floor(interpret):
    """Silence: without ``mel_floor`` the cepstra are not finite, as in
    JAX; with ``mel_floor=1.0`` they are JAX's within KERNEL_TOL."""
    cfg = MFCCConfig()
    x = np.zeros((1, 512 + 9 * 170), np.int16)
    assert not np.isfinite(dense_fused.mfcc_fmaj_plain(
        torch.from_numpy(x), cfg).numpy()).any()
    got = dense_fused.mfcc_fmaj_plain(torch.from_numpy(x), cfg,
                                      mel_floor=1.0).numpy()
    want = np.asarray(pallas_mfcc.mfcc_pallas_fmaj(jnp.asarray(x), _jcfg(cfg),
                                                   mel_floor=1.0))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= KERNEL_TOL


@pytest.mark.parametrize("nfft", [256, 512, 1024])
def test_operators_are_jax(nfft):
    """``kernel_operators`` and ``kernel_operators_folded`` are JAX's f32
    operators bit for bit; the split operator is JAX's hi + lo limbs."""
    cfg = MFCCConfig(nfft=nfft, step=HOPS[nfft])
    for mine, theirs in ((dense_fused.kernel_operators(cfg),
                          pallas_mfcc._kernel_operators(_jcfg(cfg))),
                         (dense_fused.kernel_operators_folded(cfg),
                          pallas_mfcc._kernel_operators_folded(_jcfg(cfg)))):
        for a, b in zip(mine, theirs):
            assert a.dtype == b.dtype == np.float32
            assert np.array_equal(a, b)
    CS2 = pallas_mfcc._kernel_operators_folded(_jcfg(cfg))[0]
    hi = np.asarray(jnp.asarray(CS2).astype(jnp.bfloat16), np.float32)
    lo = np.asarray(jnp.asarray(CS2 - hi).astype(jnp.bfloat16), np.float32)
    ops = dense_fused.dense_operators(cfg, torch.device("cpu"), True, True)
    assert np.array_equal(ops.cs.numpy(), hi + lo)


def test_folded_frames_start_one_sample_early():
    """The fold ingest's frame g is raw[g*hop - 1 .. g*hop + nfft - 1], the
    sample before a stream's first being 0."""
    x = torch.arange(1, 2000, dtype=torch.float32)[None]
    fr = dense_fused._frames_plain(x, MFCCConfig(), dense_fused.FOLD)
    assert fr.shape == (1, MFCCConfig().n_frames(1999), 513)
    assert fr[0, 0, 0] == 0 and fr[0, 0, 1] == 1
    assert fr[0, 2, 0] == 2 * 170 and fr[0, 2, 512] == 2 * 170 + 512


def test_entry_checks():
    """Configs outside the family and the aligned kernel's geometry raise;
    leading axes are kept."""
    x = torch.from_numpy(_noise(4, 3)).reshape(2, 2, -1)
    assert dense_fused.mfcc_fmaj(x).shape == (2, 2, 3, 32)
    with pytest.raises(ValueError, match="hop 170"):
        dense_fused.mfcc_aligned(x, MFCCConfig(step=160))
    with pytest.raises(ValueError, match="family"):
        dense_fused.mfcc_raw(x, MFCCConfig(nfft=2048, step=512))
    with pytest.raises(ValueError, match="shorter than one frame"):
        dense_fused.mfcc_seg(x[..., :500])
