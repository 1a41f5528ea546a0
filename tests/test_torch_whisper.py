"""Whisper's log-mel recipe (``WhisperConfig``, openai/whisper
``whisper/audio.py``) on the port: the plain reference ``ref/whisper_ref.py``
against whisper's own ``log_mel_spectrogram`` written literally with
``torch.stft``, the recipe's table anchors, K11's FFT schedule against
``torch.fft.fft``, the plain version and the module against the reference
(T not a multiple of 160 included, 80 and 128 mels, K11's family and the
chain outside it), its launch counters, the frames K11's silent path takes
(``silent_frames_plain`` against a brute force, the value it stores) and
every entry that cannot take the recipe raising.  Tests marked ``cuda`` run
the kernels on the card (bit for bit against the plain version, silent
frames included).  Nothing here imports JAX or ``mfcc_tpu``."""

import numpy as np
import pytest
import torch

from mfcc_tpu_torch import MFCC, FeatureServer, StreamingMFCC, tables
from mfcc_tpu_torch.compat import librosa_mfcc
from mfcc_tpu_torch.config import WHISPER_V3_LOG_MEL, WhisperConfig
from mfcc_tpu_torch.ops import fladder, whisper
from mfcc_tpu_torch.ref import whisper_ref

CPU = torch.device("cpu")
# the plain version against the float64 reference: L and the output are
# rounded to f32 (an f32 ulp of L is 4.8e-7 at |L| = 8, a quarter of it
# after the affine, plus half an ulp of the output)
PLAIN_TOL = 3e-7


def speech(S, T, seed, cut=True):
    """(S, T) int16: the benchmark's signal shape (chirp, tone, noise), each
    row zero past a speech length drawn from ``seed`` (``cut``)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000.0
    base = (9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
            + 4000 * np.sin(2 * np.pi * 900 * t))
    x = np.clip(np.round(base[None] + rng.integers(-1500, 1500, (S, T))),
                -32768, 32767).astype(np.int16)
    if cut:
        n = rng.integers(T // 8, T + 1, S)
        x[np.arange(T)[None, :] >= n[:, None]] = 0
    return torch.from_numpy(x)


def whisper_literal(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """whisper/audio.py ``log_mel_spectrogram`` on one window as whisper
    writes it, in float64: ``torch.stft`` with the periodic Hann (centre,
    reflect), the last frame dropped, |.|^2, the float32 mel bank,
    log10, the clamp over the window and the affine."""
    window = torch.hann_window(400, dtype=torch.float64)
    stft = torch.stft(audio, 400, 160, window=window, return_complex=True,
                      center=True, pad_mode="reflect")
    magnitudes = stft[..., :-1].abs() ** 2
    filters = torch.from_numpy(librosa_mfcc.mel_filterbank(
        16000, 400, n_mels).astype(np.float32)).to(torch.float64)
    mel_spec = filters @ magnitudes
    log_spec = torch.clamp(mel_spec, min=1e-10).log10()
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


@pytest.mark.parametrize("n_mels", [80, 128])
def test_reference_is_whispers_own_formula(n_mels):
    x = speech(3, 32_000, seed=n_mels)
    want = whisper_ref.log_mel(x, whisper_ref.options(n_mels=n_mels))
    assert want.shape == (3, n_mels, 200) and want.dtype == torch.float64
    for s in range(3):
        got = whisper_literal(x[s].to(torch.float64) / 32768.0, n_mels)
        assert got.shape == want[s].shape
        assert (got - want[s]).abs().max().item() <= 1e-11
    # the zeros past each speech length sit at the window's clamp
    assert (want.amin(dim=(-2, -1)) == want.amax(dim=(-2, -1)) - 2.0).all()


@pytest.mark.parametrize("n_mels,terms,widest,single,top", [
    (128, 394, 9, 45, 0.041681748), (80, 391, 14, 3, 0.025880685)])
def test_bank_anchors(n_mels, terms, widest, single, top):
    bank = tables.whisper_mel_matrix(16000, 400, n_mels)      # (201, n)
    ref = whisper_ref.mel_filters(whisper_ref.options(n_mels=n_mels))
    assert np.array_equal(bank, ref.numpy().T)
    assert np.array_equal(bank, bank.astype(np.float32).astype(np.float64))
    nz = bank != 0
    assert nz.sum() == terms
    used = np.nonzero(nz.any(axis=1))[0]
    assert (used.min(), used.max()) == (1, 199)     # never bin 0 or 200
    assert nz.sum(axis=1).max() == 2                # at most 2 terms a bin
    assert nz.sum(axis=0).max() == widest
    assert (nz.sum(axis=0) == 1).sum() == single
    assert bank.max() == pytest.approx(top, rel=1e-6)
    ops = whisper.default_operators(WhisperConfig(nfilters=n_mels), CPU)
    assert ops.steps == 13 and ops.sched is not None


def test_geometry_and_window():
    cfg = WHISPER_V3_LOG_MEL
    assert (cfg.nfft, cfg.hop, cfg.nfilters, cfg.windowlen) == (
        400, 160, 128, 400)
    assert cfg.n_samples == 480_000 and cfg.recipe == "whisper"
    assert cfg.n_frames(480_000) == 3_000 == whisper_ref.num_frames(
        480_000, whisper_ref.options())
    assert cfg.n_frames(16_037) == 100
    np.testing.assert_allclose(tables.whisper_window(400),
                               torch.hann_window(400, dtype=torch.float64),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(whisper_ref.hann(400),
                               torch.hann_window(400, dtype=torch.float64),
                               rtol=0, atol=1e-15)
    for bad in ({"nfft": 401}, {"window_samples": 300}, {"nfilters": 201},
                {"step": 401}):
        with pytest.raises(ValueError):
            WhisperConfig(**bad)


def test_frame_index_reflects_at_both_ends():
    T = 970
    idx = whisper.frame_index(T, WHISPER_V3_LOG_MEL, CPU)
    assert idx.shape == (6, 400)
    assert torch.equal(idx[0, :201], torch.arange(200, -1, -1))
    assert torch.equal(idx[0, 200:], torch.arange(0, 200))
    n = 5 * 160 - 200 + torch.arange(400)           # the last frame
    want = torch.where(n >= T, 2 * T - 2 - n, n)
    assert torch.equal(idx[5], want) and int(idx[5, -1]) == 939
    assert torch.equal(idx, whisper_ref.frame_index(
        T, whisper_ref.options(), CPU))
    # only frames 0, 1 and F - 1 reach past an end
    F = 3_000
    big = whisper.frame_index(480_000, WHISPER_V3_LOG_MEL, CPU)
    n = (torch.arange(F)[:, None] * 160 - 200 + torch.arange(400)[None])
    touched = ((n < 0) | (n >= 480_000)).any(dim=1).nonzero().flatten()
    assert touched.tolist() == [0, 1, 2_999]
    assert (big >= 0).all() and (big < 480_000).all()
    n = (torch.arange(100)[:, None] * 160 - 200 + torch.arange(400)[None])
    assert ((n < 0) | (n >= 16_037)).any(dim=1).nonzero().flatten(
        ).tolist() == [0, 1, 99]


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_fft_schedule_is_the_dft(seed):
    g = torch.Generator().manual_seed(seed)
    z = torch.complex(torch.randn(5, 200, generator=g, dtype=torch.float64),
                      torch.randn(5, 200, generator=g, dtype=torch.float64))
    got = whisper.fft_model(z)
    assert (got - torch.fft.fft(z)).abs().max().item() < 1e-12


@pytest.mark.parametrize("S,T,n_mels", [(3, 32_000, 128), (2, 16_037, 128),
                                        (3, 201, 128), (2, 4_077, 80),
                                        (1, 480_000, 128)])
def test_plain_and_module_match_the_reference(S, T, n_mels):
    cfg = WhisperConfig(nfilters=n_mels)
    x = speech(S, T, seed=T + n_mels)
    want = whisper_ref.log_mel(x, whisper_ref.options(n_mels=n_mels))
    fe = MFCC(cfg, device="cpu")
    before = whisper.WHISPER_LAUNCHES, whisper.WHISPER_NORM_LAUNCHES
    for got in (whisper.log_mel_plain(x, cfg), fe(x),
                whisper.log_mel(x, cfg), fe(x.float())):
        assert got.shape == (S, n_mels, T // 160)
        assert got.dtype == torch.float32
        assert torch.isfinite(got).all()
        assert (got.double() - want).abs().max().item() <= PLAIN_TOL
    assert (whisper.WHISPER_LAUNCHES, whisper.WHISPER_NORM_LAUNCHES) == before
    assert whisper.config_ok(cfg)


def test_the_chain_outside_the_family():
    """nfft 512 at hop 128 is the recipe's, outside K11's family: the
    module runs the plain version, which holds the reference."""
    cfg = WhisperConfig(nfft=512, step=128, nfilters=96)
    assert not whisper.config_ok(cfg)
    x = speech(2, 9_000, seed=4)
    want = whisper_ref.log_mel(x, whisper_ref.options(
        n_fft=512, hop_length=128, n_mels=96))
    got = MFCC(cfg, device="cpu")(x)
    assert got.shape == want.shape == (2, 96, 70)
    assert (got.double() - want).abs().max().item() <= PLAIN_TOL


def test_module_layout_state_and_leading_axes():
    x = speech(4, 8_000, seed=7)
    fe = MFCC(WHISPER_V3_LOG_MEL, device="cpu")
    full = fe(x)
    assert torch.equal(fe(x.reshape(2, 2, -1)), full.reshape(2, 2, 128, 50))
    assert torch.equal(fe(x.float()), full)
    state = fe.state_dict()
    assert state["window"].shape == (400,) and state["mel"].shape == (201, 128)
    assert state["dct"].shape == (128, 0)
    fe2 = MFCC(WHISPER_V3_LOG_MEL, device="cpu")
    fe2.load_state_dict(state)
    assert torch.equal(fe2(x), full)
    # a silent window: every value at the clamp's floor, finite
    silent = fe(torch.zeros((1, 4_000), dtype=torch.int16))
    assert torch.equal(silent, torch.full_like(silent, (-10.0 + 4) / 4))


def test_operators_follow_the_modules_buffers():
    fe = MFCC(WHISPER_V3_LOG_MEL, device="cpu")
    ops = fe._whisper_ops()
    assert fe._whisper_ops() is ops
    assert torch.equal(ops.window * 32768.0, fe.window)
    assert ops.twiddles.shape == (400, 2)
    mel = fe.mel.clone()
    mel[200, 0] = 1.0                       # a weight on the Nyquist bin
    fe.load_numpy_operators({"mel": mel.numpy()})
    ops2 = fe._whisper_ops()
    assert ops2 is not ops and ops2.sched is None and ops2.steps == 0
    assert whisper.schedule_words(mel.numpy()) is None


def test_counters_and_the_launch_guard():
    assert isinstance(whisper.WHISPER_LAUNCHES, int)
    assert isinstance(whisper.WHISPER_NORM_LAUNCHES, int)
    x = torch.zeros((1, 1_000), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        whisper.log_mel(x, WHISPER_V3_LOG_MEL)
    with pytest.raises(ValueError, match="outside K11's family"):
        whisper.log_mel(x, WhisperConfig(nfft=512))
    assert whisper.tiles_per_window(3_000) == 94
    assert whisper.tiles_per_window(32) == 1


def test_entries_that_cannot_take_the_recipe_raise():
    cfg = WHISPER_V3_LOG_MEL
    fe = MFCC(cfg, device="cpu")
    x = np.zeros((1, 4_000), np.int16)
    with pytest.raises(ValueError, match="no INT path"):
        fe.int(x)
    with pytest.raises(ValueError, match="no INT path"):
        fe.int_frames(np.zeros((1, 2, 400), np.int16))
    with pytest.raises(ValueError, match="frames entry"):
        fe.frames(np.zeros((1, 2, 400), np.float32))
    with pytest.raises(ValueError):
        fe.intermediates(x)
    with pytest.raises(ValueError, match="streaming step"):
        StreamingMFCC(cfg, device="cpu")
    with pytest.raises(ValueError, match="streaming step"):
        FeatureServer(cfg, device="cpu")
    from mfcc_tpu_torch.parallel import halo, sharding
    with pytest.raises(ValueError, match="FPGA recipe"):
        sharding.mfcc_sharded_fn(None, cfg)
    with pytest.raises(ValueError, match="FPGA recipe"):
        halo.mfcc_halo_fn(None, cfg)
    for kw in ({"precision": "fast"}, {"mel_floor": 1.0},
               {"method": "rfft"}, {"dtype": torch.float64}):
        with pytest.raises(ValueError):
            MFCC(cfg, device="cpu", **kw)


@pytest.mark.parametrize("T", [200, 100])
def test_windows_too_short_to_reflect_raise(T):
    x = torch.zeros((1, T), dtype=torch.int16)
    with pytest.raises(ValueError, match="reflect"):
        MFCC(WHISPER_V3_LOG_MEL, device="cpu")(x)
    with pytest.raises(ValueError, match="reflect"):
        whisper_ref.log_mel(x, whisper_ref.options())


def test_mel_schedule_capacity_is_the_kernels():
    """K11's table holds 16 steps a lane where K1's rule (nbins / 16) would
    give 12 at 200 bins: the bank's 13 steps need the kernel's own cap;
    K1's callers keep their rule."""
    bank = tables.whisper_mel_matrix(16000, 400, 128)[:200]
    assert fladder.mel_schedule(bank) is None
    words = fladder.mel_schedule(bank, cap=whisper.MEL_CAP)
    assert len(words) == 13 * 32 * 4 + 128
    assert fladder.mel_schedule(bank, cap=12) is None


def silent_cases(T, f32=False, cfg=WHISPER_V3_LOG_MEL):
    """(rows, T) windows that exercise K11's silent path: speech then
    zeros, zeros then speech then zeros, an all-zero window amid speech,
    and one nonzero sample alone at the first or the last of the reflected
    positions of frames 0, 1, the middle one and the last (with f32,
    the zeros of every other row are -0.0).  Returns (windows, the
    (frame, row) of each lone sample)."""
    F = cfg.n_frames(T)
    idx = whisper.frame_index(T, cfg, CPU)
    talk = speech(4, T, seed=T, cut=False)
    rows = [speech(1, T, seed=T + 1)[0], torch.zeros(T, dtype=torch.int16),
            talk[0].clone(), talk[1]]
    rows[2][: T // 3] = 0
    rows[2][2 * T // 3:] = 0
    lone = []
    for f in sorted({min(f, F - 1) for f in (0, 1, F // 2, F - 1)}):
        for pos in (0, cfg.nfft - 1):
            x = torch.zeros(T, dtype=torch.int16)
            x[idx[f, pos]] = 1_000
            lone.append((f, len(rows)))
            rows.append(x)
    rows.append(talk[2])
    x = torch.stack(rows)
    if f32:
        x = x.float()
        x[::2] = torch.where(x[::2] == 0, -0.0, x[::2])
    return x, lone


@pytest.mark.parametrize("T,f32", [(201, False), (560, True), (970, False),
                                   (4_077, True), (16_037, False),
                                   (48_000, True)])
def test_silent_frames_plain_is_the_brute_force(T, f32):
    cfg = WHISPER_V3_LOG_MEL
    x, lone = silent_cases(T, f32)
    got = whisper.silent_frames_plain(x, cfg)
    want = (x[:, whisper.frame_index(T, cfg, CPU)] == 0).all(-1)
    assert got.shape == (x.shape[0], T // 160) and torch.equal(got, want)
    for f, r in lone:                  # a lone sample: never silent
        assert not got[r, f]
    assert got[1].all() and not got[3].any()
    assert torch.equal(whisper.silent_frames_plain(x.reshape(1, -1, T), cfg),
                       got[None])


@pytest.mark.parametrize("nfft,hop", [(400, 160), (400, 320), (512, 128)])
def test_silent_frames_plain_counts_nan_and_not_negative_zero(nfft, hop):
    cfg = WhisperConfig(nfft=nfft, step=hop)
    T = 3_001
    idx = whisper.frame_index(T, cfg, CPU)
    x = torch.full((4, T), -0.0)
    x[1, 1_500] = float("nan")
    x[2, 0] = float("inf")
    x[3, idx[-1, -1]] = 1e-30
    got = whisper.silent_frames_plain(x, cfg)
    want = (x[:, idx] == 0).all(-1)
    assert torch.equal(got, want)
    assert got[0].all() and got.shape == (4, T // hop)
    assert not got[1].all() and not got[2, 0] and not got[3, -1]


def test_silent_level_is_the_plain_versions_value():
    """The value K11 stores for a frame of zeros is the plain version's:
    log10 of the 1e-10 floor, -10 in f32, through the clamp and the affine
    both where it is the window's max and where it is above max - 8."""
    cfg = WHISPER_V3_LOG_MEL
    # K11's silent_level: log2 of the floor times log10(2), rounded to f32
    level = float(np.float32(np.log2(cfg.log_floor) * 0.30102999566398119521))
    assert level == np.float32(np.log10(1e-10)) == -10.0
    zeros = whisper.log_mel_plain(torch.zeros((2, 4_000), dtype=torch.int16),
                                  cfg)
    want = (torch.tensor(level, dtype=torch.float32) + 4.0) * 0.25
    assert torch.equal(zeros, torch.full_like(zeros, want.item()))
    quiet = torch.zeros((1, 16_000), dtype=torch.int16)
    quiet[0, :8_000] = torch.from_numpy(
        np.random.default_rng(0).integers(-1, 2, 8_000).astype(np.int16))
    out = whisper.log_mel_plain(quiet, cfg)
    silent = whisper.silent_frames_plain(quiet, cfg)[0]
    assert silent.sum() == 100 - (8_000 + 200 + 159) // 160
    assert out.max() * 4 - 4 - 8 < level      # the clamp keeps the level
    assert torch.equal(out[0][:, silent],
                       torch.full_like(out[0][:, silent], want.item()))


def test_silent_counters_on_the_plain_path():
    """``WHISPER_FRAMES`` counts the frames of K11's launches and
    ``silent_frames`` reads K11's device count: the plain version on the
    CPU advances neither, and a launch refused before K11 counts none."""
    assert isinstance(whisper.WHISPER_FRAMES, int)
    before = whisper.WHISPER_FRAMES
    x = torch.zeros((3, 16_000), dtype=torch.int16)
    MFCC(WHISPER_V3_LOG_MEL, device="cpu")(x)
    whisper.log_mel(x, WHISPER_V3_LOG_MEL)
    assert whisper.silent_frames("cpu") == 0
    assert whisper.silent_frames(CPU) == 0
    with pytest.raises(ValueError, match="CUDA or CPU"):
        whisper.log_mel(x.to("meta"), WHISPER_V3_LOG_MEL)
    assert whisper.WHISPER_FRAMES == before


# -- on the card ------------------------------------------------------------------

# K11 + K11-norm against their plain version: both FP64 to the log and L
# rounded to f32 once, log10 as log2 * log10(2) in the kernel (measured
# equal bit for bit at the cell's size, H100 80GB HBM3)
KERNEL_TOL = 1e-6
GATE = 1e-5           # the whisper_v3_logmel configuration's limit


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,n_mels,f32", [
    (4, 480_000, 128, False), (4, 480_000, 128, True),
    (5, 16_037, 128, False), (3, 201, 128, False), (4, 480_000, 80, False),
    (2, 33_333, 80, True)])
def test_card_kernels_match_plain_and_reference(dev, S, T, n_mels, f32):
    cfg = WhisperConfig(nfilters=n_mels)
    x = speech(S, T, seed=S * T + n_mels).to(dev)
    if f32:
        x = x.float()
    before = whisper.WHISPER_LAUNCHES, whisper.WHISPER_NORM_LAUNCHES
    got = MFCC(cfg, device=dev)(x)
    torch.cuda.synchronize()
    assert (whisper.WHISPER_LAUNCHES, whisper.WHISPER_NORM_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == (S, n_mels, T // 160) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    plain = whisper.log_mel_plain(x, cfg)
    assert (got - plain).abs().max().item() <= KERNEL_TOL
    want = whisper_ref.log_mel(x, whisper_ref.options(n_mels=n_mels))
    assert (got.double() - want).abs().max().item() <= GATE


@pytest.mark.cuda
def test_card_layouts_and_inputs_agree(dev):
    x = speech(6, 48_000, seed=3).to(dev)
    fe = MFCC(WHISPER_V3_LOG_MEL, device=dev)
    full = fe(x)
    assert torch.equal(fe(x.float()), full)
    assert torch.equal(fe(x.reshape(2, 3, -1)), full.reshape(2, 3, 128, 300))
    assert torch.equal(whisper.log_mel(x, WHISPER_V3_LOG_MEL), full)
    # each window's clamp is its own: a window alone gives its rows
    assert torch.equal(fe(x[4:5]), full[4:5])


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels,f32", [(128, False), (128, True),
                                        (80, False), (80, True)])
@pytest.mark.parametrize("T", [201, 250, 16_037, 48_000])
def test_card_silent_path_is_the_full_path(dev, T, n_mels, f32):
    """K11's silent frames, and its wholly silent tiles, give the plain
    version's output bit for bit, K11-norm's clamp included; the frames it
    counts are those whose samples are all zero, and a lone sample at
    either end of a frame's reflected positions (frames 0, 1 and F - 1
    reflect) sends that frame down the full path.  At T = 201 and 250 the
    window is one frame, whose first reflected position is sample 200: the
    tile check has to read it too."""
    cfg = WhisperConfig(nfilters=n_mels)
    x, _ = silent_cases(T, f32, cfg)
    x = x.to(dev)
    want_silent = int(whisper.silent_frames_plain(x, cfg).sum())
    frames, silent = whisper.WHISPER_FRAMES, whisper.silent_frames(dev)
    got = MFCC(cfg, device=dev)(x)
    assert whisper.silent_frames(dev) - silent == want_silent
    assert whisper.WHISPER_FRAMES - frames == x.shape[0] * (T // 160)
    assert torch.equal(got, whisper.log_mel_plain(x, cfg))
