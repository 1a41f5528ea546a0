"""SeamlessM4T's fbank (``SeamlessFbankConfig``, w2v-BERT 2.0's extractor) in
the port: its configuration and bank, the plain reference against Hugging
Face's ``SeamlessM4TFeatureExtractor`` itself, the recipe's plain route
against the reference on ragged batches, the entries that refuse it, and
(marked ``cuda``, on the card only) K12 and K12-cmvn against the plain
route.  Nothing here imports JAX or ``mfcc_tpu``."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mfcc_tpu_torch import (MFCC, FeatureServer, StreamingMFCC,
                            W2V_BERT_2_FBANK, SeamlessFbankConfig,
                            WHISPER_V3_LOG_MEL, tables)
from mfcc_tpu_torch.ops import fladder, seamless
from mfcc_tpu_torch.ref import seamless_ref

ROOT = Path(__file__).resolve().parents[1]
OPTS = seamless_ref.options()
# the w2v_bert2_fbank configuration's limit on max |program - reference|
GATE = json.loads((ROOT / "perfbench/configs/w2v_bert2_fbank.json")
                  .read_text())["limit"]


def speech(lengths, T, seed):
    """(B, T) int16: a chirp and noise for each utterance's length, zeros
    after it."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000
    x = np.zeros((len(lengths), T), np.int16)
    for i, n in enumerate(lengths):
        s = (9000 * np.sin(2 * np.pi * (200 + 3000 * t[:n]) * t[:n])
             + 4000 * np.sin(2 * np.pi * (300 + 97 * i) * t[:n])
             + rng.integers(-1500, 1500, n))
        x[i, :n] = np.clip(np.round(s), -32768, 32767)
    return torch.from_numpy(x)


def test_configuration_holds_the_extractors_geometry():
    cfg = W2V_BERT_2_FBANK
    assert (cfg.nfft, cfg.windowlen, cfg.hop, cfg.nfilters) == (
        512, 400, 160, 80)
    assert cfg.recipe == "seamless" and cfg.high_freq == 8000.0
    assert cfg.min_samples == 560 and cfg.n_frames(560) == 2
    assert cfg.n_frames(559) == 1 and cfg.n_frames(320_000) == 1998
    assert cfg.stride == 2 and cfg.variance_floor == 1e-7
    for kw in ({"nfft": 1024}, {"window_samples": 401}, {"step": 170},
               {"nfilters": 0}, {"nfilters": 257}):
        with pytest.raises(ValueError):
            SeamlessFbankConfig(**kw)


def test_bank_is_kaldis_and_fills_the_schedule():
    """Kaldi's bank over 20-8,000 Hz from the tables' equations equals the
    reference's; its 501 terms take the balanced schedule's 16 steps a
    lane, the table's whole capacity at nfft 512."""
    mel = tables.seamless_mel_matrix(16000, 512, 80)
    want = seamless_ref.mel_banks(OPTS).numpy()
    assert mel.shape == (256, 80) and int((mel != 0).sum()) == 501
    np.testing.assert_allclose(mel, want, rtol=0, atol=1e-13)
    assert np.array_equal(mel != 0, want != 0)
    words = fladder.mel_schedule(mel)
    assert (len(words) - 80) // 128 == 16 and fladder.mel_steps_fit(16, 256)
    for n in (1, 40, 128, 200, 256):       # K12's family: every bin count
        assert fladder.mel_schedule(tables.seamless_mel_matrix(
            16000, 512, n)) is not None


HF_CASES = {"odd_and_even": [16_037, 112_123, 48_000 + 160 * 7 + 1, 80_000],
            "one_utterance": [54_321]}


@pytest.mark.parametrize("case", sorted(HF_CASES))
def test_reference_is_the_extractor(case):
    """The float64 reference against ``SeamlessM4TFeatureExtractor``
    itself, features and mask.  The extractor rounds its spectrum to
    complex64 and takes the log and the statistics in float32: ~1e-6 of a
    log-mel in the tens, divided by its bin's spread over the utterance,
    a few units where speech moves but ~0.05 in a bin a steady tone
    fills; these utterances read 2.3e-6 (one chirp) to 2.0e-5 (a tone
    beside it), so 1e-4 leaves five times the worst."""
    transformers = pytest.importorskip("transformers")
    lengths = HF_CASES[case]
    x = speech(lengths, max(lengths), seed=len(lengths))
    fe = transformers.SeamlessM4TFeatureExtractor()
    hf = fe([x[i, :n].numpy().astype(np.float32) / 32768
             for i, n in enumerate(lengths)], sampling_rate=16000,
            return_tensors="pt")
    feats, mask = seamless_ref.features(x, torch.tensor(lengths), OPTS)
    assert hf["input_features"].shape == feats.shape
    assert torch.equal(hf["attention_mask"], mask)
    assert (hf["input_features"].double() - feats).abs().max() < 1e-4


# (lengths, T): odd and even F, F = 2 (560 samples) and 3, every row whole
PLAIN_CASES = {"ragged": ([16_037, 48_123, 560, 80_000, 719, 720], 80_050),
               "whole_rows": (None, 33_333), "two_frames": ([560, 560], 560),
               "odd_longest": ([16_000 + 160 * 4, 1_000], 17_000)}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_plain_route_matches_the_reference(case):
    lengths, T = PLAIN_CASES[case]
    B = 2 if lengths is None else len(lengths)
    x = speech(lengths or [T] * B, T, seed=T)
    fe = MFCC(W2V_BERT_2_FBANK, device="cpu")
    got, mask = fe(x, lengths)
    want, want_mask = seamless_ref.features(x, lengths, OPTS)
    assert got.dtype == torch.float32 and mask.dtype == torch.int32
    assert got.shape == want.shape and torch.equal(mask, want_mask)
    assert (got.double() - want).abs().max() <= GATE
    counts = [W2V_BERT_2_FBANK.n_frames(n) for n in (lengths or [T] * B)]
    Fp = got.shape[1] * 2
    assert Fp == max(counts) + max(counts) % 2
    rows = got.reshape(B, Fp, 80)
    for s, F in enumerate(counts):
        assert not rows[s, F:].any()
        assert torch.equal(mask[s], (torch.arange(1, Fp, 2) < F).int())
    assert torch.equal(fe(x.float(), lengths)[0], got)
    assert torch.equal(fe(x[0], None if lengths is None
                          else lengths[:1])[0][0],
                       seamless.fbank_plain(x[:1], None if lengths is None
                                            else lengths[:1],
                                            W2V_BERT_2_FBANK)[0][0])


@pytest.mark.parametrize("lengths,T", [([559], 1_000), ([1_001], 1_000),
                                       ([600, 100], 1_000)])
def test_lengths_outside_the_recipe_raise(lengths, T):
    x = torch.zeros((len(lengths), T), dtype=torch.int16)
    with pytest.raises(ValueError, match="two frames"):
        MFCC(W2V_BERT_2_FBANK, device="cpu")(x, lengths)
    with pytest.raises(ValueError, match="two frames"):
        seamless_ref.features(x, lengths, OPTS)


def test_lengths_must_be_whole_numbers_one_an_utterance():
    fe = MFCC(W2V_BERT_2_FBANK, device="cpu")
    x = torch.zeros((2, 1_000), dtype=torch.int16)
    for bad in ([600.0, 700.0], [600], torch.tensor([[600, 700]])):
        with pytest.raises(ValueError, match="whole numbers"):
            fe(x, bad)
    with pytest.raises(ValueError, match="takes no lengths"):
        MFCC(device="cpu")(x, [600, 700])


def test_entries_that_cannot_take_the_recipe_raise():
    cfg = W2V_BERT_2_FBANK
    fe = MFCC(cfg, device="cpu")
    x = np.zeros((1, 4_000), np.int16)
    with pytest.raises(ValueError, match="no INT path"):
        fe.int(x)
    with pytest.raises(ValueError, match="no INT path"):
        fe.int_frames(np.zeros((1, 2, 512), np.int16))
    with pytest.raises(ValueError, match="has no frames entry"):
        fe.frames(np.zeros((1, 2, 512), np.float32))
    with pytest.raises(ValueError, match="FPGA recipe's stages"):
        fe.intermediates(x)
    with pytest.raises(ValueError, match="has no streaming step"):
        StreamingMFCC(cfg, device="cpu")
    with pytest.raises(ValueError, match="has no streaming step"):
        FeatureServer(cfg, device="cpu")
    from mfcc_tpu_torch.parallel import halo, sharding
    with pytest.raises(ValueError, match="FPGA recipe, not 'seamless'"):
        sharding.mfcc_sharded_fn(None, cfg)
    with pytest.raises(ValueError, match="FPGA recipe, not 'seamless'"):
        halo.mfcc_halo_fn(None, cfg)
    for kw in ({"precision": "fast"}, {"mel_floor": 1.0},
               {"method": "rfft"}, {"dtype": torch.float64}):
        with pytest.raises(ValueError, match="FLT_EPSILON itself"):
            MFCC(cfg, device="cpu", **kw)


def test_the_command_line_has_no_way_to_the_recipe(capsys):
    """Every computing command builds ``MFCCConfig(nceptrums=...)``: none
    takes a recipe, so the command line cannot reach SeamlessM4T's fbank
    and argparse refuses an option that would ask for it."""
    from mfcc_tpu_torch import cli
    for cmd in (["convert", "wavs"], ["stream", "-"], ["serve"],
                ["selftest"], ["probe", "x.wav"]):
        with pytest.raises(SystemExit):
            cli.main(cmd + ["--recipe=seamless"])
        assert "unrecognized arguments: --recipe=seamless" in \
            capsys.readouterr().err


def test_counters_and_the_launch_guard():
    for name in ("FBANK_LAUNCHES", "CMVN_LAUNCHES", "FBANK_FRAMES"):
        assert isinstance(getattr(seamless, name), int)
    before = (seamless.FBANK_LAUNCHES, seamless.CMVN_LAUNCHES,
              seamless.FBANK_FRAMES)
    x = torch.zeros((1, 1_000), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        seamless.fbank(x, None, W2V_BERT_2_FBANK)
    with pytest.raises(ValueError, match="outside K12's family"):
        seamless.fbank(x, None, WHISPER_V3_LOG_MEL)
    MFCC(W2V_BERT_2_FBANK, device="cpu")(speech([4_000], 4_000, 1))
    assert (seamless.FBANK_LAUNCHES, seamless.CMVN_LAUNCHES,
            seamless.FBANK_FRAMES) == before


def test_kernel_source_names_its_kernels():
    """The device trace names the kernels: the cell's reader looks for
    ``fbank_cmvn``; the walk runs K1-Kaldi's ingest and the tail's power
    and mel stages, no copy of them."""
    src = (ROOT / "mfcc_tpu_torch/csrc/seamless_fbank.cu").read_text()
    assert "fbank_walk(" in src and "fbank_cmvn(" in src
    for stage in ("kaldi_ingest<kLog2P>", "ladder_power<kLog2P>",
                  "mel_log2<"):
        assert stage in src
    assert "fft_pass" not in src and "bin_power" not in src


# K12 + K12-cmvn against their plain version: both FP64 until the
# normalised value, rounded to f32 once; they may round a value either
# way where the FP64 interiors differ in the last bits (an f32 ulp: 4.8e-7
# at |x| < 8, 9.5e-7 below 16)
KERNEL_TOL = 1e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


CARD_CASES = {"edges": ([560, 561, 719, 720, 16_037, 80_000, 80_000 - 1],
                        80_000),
              "whole_rows": (None, 48_000), "one": ([33_333], 40_000),
              "two_frames": ([560], 560),
              "many": ([560 + 997 * i for i in range(300)], 560 + 997 * 299)}


@pytest.mark.cuda
@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_card_kernels_match_plain_and_reference(dev, case, f32):
    lengths, T = CARD_CASES[case]
    B = 3 if lengths is None else len(lengths)
    x = speech(lengths or [T] * B, T, seed=B * T).to(dev)
    if f32:
        x = x.float()
    counts = [W2V_BERT_2_FBANK.n_frames(n) for n in (lengths or [T] * B)]
    before = (seamless.FBANK_LAUNCHES, seamless.CMVN_LAUNCHES,
              seamless.FBANK_FRAMES)
    got, mask = MFCC(W2V_BERT_2_FBANK, device=dev)(
        x, None if lengths is None else torch.tensor(lengths))
    torch.cuda.synchronize()
    assert (seamless.FBANK_LAUNCHES, seamless.CMVN_LAUNCHES,
            seamless.FBANK_FRAMES) == (before[0] + 1, before[1] + 1,
                                       before[2] + sum(counts))
    plain, plain_mask = seamless.fbank_plain(x, lengths, W2V_BERT_2_FBANK)
    assert got.shape == plain.shape and got.dtype == torch.float32
    assert torch.equal(mask, plain_mask)
    assert torch.isfinite(got).all()
    assert (got - plain).abs().max().item() <= KERNEL_TOL
    Fp = got.shape[1] * 2
    rows = got.reshape(B, Fp, 80)
    for s, F in enumerate(counts):
        assert not rows[s, F:].any()        # exact zeros in the padding
    want, _ = seamless_ref.features(x, lengths, OPTS)
    assert (got.double() - want).abs().max().item() <= GATE


@pytest.mark.cuda
def test_card_batch_order_is_the_outputs_order(dev):
    """The walk's ragged work list and the statistics a block an utterance
    make each utterance's rows its own: a permuted batch gives the
    permuted rows bit for bit, and an utterance alone its row."""
    lengths = [560 + 1_613 * i for i in range(40)]
    T = max(lengths) + 17
    x = speech(lengths, T, seed=5).to(dev)
    fe = MFCC(W2V_BERT_2_FBANK, device=dev)
    got, mask = fe(x, lengths)
    perm = torch.randperm(40, generator=torch.Generator().manual_seed(3))
    pg, pm = fe(x[perm.to(dev)].contiguous(),
                [lengths[i] for i in perm.tolist()])
    assert torch.equal(pg, got[perm.to(dev)]) and torch.equal(
        pm, mask[perm.to(dev)])
    one, _ = fe(x[7:8].contiguous(), lengths[7:8])
    F = W2V_BERT_2_FBANK.n_frames(lengths[7])
    assert torch.equal(one.reshape(-1, 80)[:F],
                       got[7].reshape(-1, 80)[:F])


@pytest.mark.cuda
def test_card_cell_shape(dev):
    """The w2vbert.batch cell's call: 384 utterances of 1-20 s in T =
    320,000, F_pad 1,996."""
    B = 384
    q = 1 + 19 * (np.arange(B) + 0.5) / B
    lengths = np.random.default_rng(0).permutation(
        np.round(q * 16000).astype(np.int64))
    x = speech(lengths.tolist(), 320_000, seed=11).to(dev)
    got, mask = MFCC(W2V_BERT_2_FBANK, device=dev)(x, torch.from_numpy(
        lengths))
    assert got.shape == (384, 998, 160) and mask.shape == (384, 998)
    plain, plain_mask = seamless.fbank_plain(x, lengths, W2V_BERT_2_FBANK)
    assert torch.equal(mask, plain_mask)
    assert (got - plain).abs().max().item() <= KERNEL_TOL
