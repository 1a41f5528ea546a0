"""K11 and K11-norm: Whisper's log-mel front-end (``config.WhisperConfig``,
openai/whisper ``whisper/audio.py`` ``log_mel_spectrogram``) on the card.

(..., T) int16 or f32 samples in int16's scale -> (..., nfilters, T // hop)
f32, in two launches (``csrc/whisper_mel.cu``):

* K11, ``whisper_logmel_kernel``: the reflect-padded frames, 1/32768 and
  the periodic Hann, a 400-point real DFT as a 200-point complex FFT (radix
  8, 5, 5), |X|^2, the mel product on K1's balanced term schedule with the
  1e-10 floor and the log (``fladder_stages.cuh`` ``mel_log2``), log10
  stored through a shared-memory tile transposed into (B, nfilters, F),
  and each tile's maximum;
* K11-norm, ``whisper_norm_kernel``: each window's maximum from its tiles',
  then max(L, max - 8) and (L + 4) / 4 in place.

``log_mel`` is the wrapper: a CUDA tensor launches both (or the wrapper
raises), a CPU tensor takes ``log_mel_plain``, the same function as a chain
of float64 torch ops, which is also the recipe's route outside K11's family
(``config_ok``).  ``WHISPER_LAUNCHES`` and ``WHISPER_NORM_LAUNCHES`` count
the two kernels' launches, ``WHISPER_FRAMES`` the frames K11 was launched
on.

K11's silent path: a frame whose 400 reflected samples are all zero
(``silent_frames_plain``; Whisper's padding to 30 s) gets L =
log2(1e-10) log10(2) rounded to f32, the value its FFT, mel, floor and log
give, without computing them.  K11 adds the frames it took that way to a device int64
of each device (no synchronization on the call); ``silent_frames(device)``
reads it.

Precision: K11 runs in FP64, as the FP64 tail's stages it shares, and
rounds L to f32 once at the store; K11-norm's clamp and affine run in f32
on the stored L, as the plain version computes them.  Whisper itself
computes in float32.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import tables
from ..config import MFCCConfig, WhisperConfig
from ..kernels import build
from . import fladder

WHISPER_LAUNCHES = 0        # K11 launches by log_mel (never the plain path)
WHISPER_NORM_LAUNCHES = 0   # K11-norm launches by log_mel
WHISPER_FRAMES = 0          # frames of those K11 launches

# K11's geometry (csrc/whisper_mel.cu): nfft 400 as 200 packed points, at
# most 128 filters, frames a tile of the transposed store, and the mel
# schedule's table capacity in steps a lane
NFFT = 400
MAX_FILTERS = 128
TILE_FRAMES = 32
MEL_CAP = 16
INT16_SCALE = 32768.0       # load_audio's scale


class WhisperOperators(NamedTuple):
    """The recipe's tables on one device."""
    window: torch.Tensor    # (nfft,) float64 periodic Hann / 32768
    mel: torch.Tensor       # (nfft/2 + 1, nfilters) float64, f32-rounded
    twiddles: torch.Tensor  # (nfft, 2) float64 [Re, Im] exp(-2 pi i k/nfft)
    sched: torch.Tensor | None   # K11's mel schedule (int32), or None
    steps: int              # its steps a lane (0 with no schedule)


def check_dials(method: str, precision: str, dtype: torch.dtype,
                mel_floor: float) -> None:
    """Raise unless the dials are the ones Whisper's recipe runs at: it
    states its own floor (1e-10) and log (log10)."""
    if (method != "dft" or precision != "highest"
            or dtype != torch.float32 or mel_floor):
        raise ValueError(
            "Whisper's recipe runs with method=\"dft\", precision=\"highest\","
            " float32 and no mel_floor (it floors at 1e-10 itself)")


def refuse(cfg: MFCCConfig, entry: str) -> None:
    """Raise for an entry that Whisper's recipe does not define."""
    if cfg.recipe == "whisper":
        raise ValueError(
            f"Whisper's recipe has no {entry}: its clamp takes the maximum "
            "over the whole window, so it is defined on whole windows only; "
            "call MFCC(cfg)(audio) on (B, T) windows")


def schedule_words(mel: np.ndarray) -> np.ndarray | None:
    """K11's mel schedule of the (nfft/2 + 1, nfilters) bank ``mel``
    (``fladder.mel_schedule`` over bins [0, nfft/2) on a table of MEL_CAP
    steps a lane), or None where the bank weighs the Nyquist bin, which
    K11 does not compute, or its schedule does not fit."""
    mel = np.asarray(mel, np.float64)
    nbins = mel.shape[0] - 1
    if mel[nbins].any() or mel.shape[1] > MAX_FILTERS:
        return None
    return fladder.mel_schedule(mel[:nbins], cap=MEL_CAP)


@functools.lru_cache(maxsize=None)
def config_ok(cfg: MFCCConfig) -> bool:
    """K11's family: Whisper's recipe at nfft 400 with at most 128 filters
    whose default bank K11's schedule holds (large-v3's 128 and v1-v2's 80
    at 16 kHz, any hop)."""
    if cfg.recipe != "whisper" or cfg.nfft != NFFT:
        return False
    return schedule_words(tables.whisper_mel_matrix(
        cfg.samplerate, cfg.nfft, cfg.nfilters)) is not None


@functools.lru_cache(maxsize=None)
def twiddles(nfft: int, device: torch.device) -> torch.Tensor:
    """(nfft, 2) float64 [Re, Im] of exp(-2 pi i k / nfft)."""
    ang = 2.0 * np.pi * np.arange(nfft) / nfft
    return torch.as_tensor(np.stack([np.cos(ang), -np.sin(ang)], axis=1),
                           device=device)


def make_operators(window: torch.Tensor, mel: torch.Tensor
                   ) -> WhisperOperators:
    """The operators of a Hann ``window`` (nfft,) and a mel bank (nfft/2 +
    1, nfilters), float64 on one device: the window over 32768, the
    twiddles and K11's schedule (None where it has none)."""
    nfft = window.shape[0]
    words = schedule_words(mel.detach().cpu().numpy())
    sched = (None if words is None
             else torch.as_tensor(words, device=mel.device))
    steps = 0 if words is None else (
        (len(words) - mel.shape[1])
        // (fladder.MEL_LANES * fladder.MEL_ENTRY_WORDS))
    return WhisperOperators(
        (window.detach() / INT16_SCALE).to(torch.float64).contiguous(),
        mel.detach().to(torch.float64).contiguous(),
        twiddles(nfft, window.device), sched, steps)


@functools.lru_cache(maxsize=None)
def default_operators(cfg: WhisperConfig, device: torch.device
                      ) -> WhisperOperators:
    """The recipe's tables of ``cfg`` on ``device``, cached."""
    win = torch.as_tensor(tables.whisper_window(cfg.nfft), device=device)
    mel = torch.as_tensor(tables.whisper_mel_matrix(
        cfg.samplerate, cfg.nfft, cfg.nfilters), device=device)
    return make_operators(win, mel)


def check_length(T: int, cfg: MFCCConfig) -> None:
    """Raise for a window too short to reflect by nfft/2 or to hold a
    frame."""
    if T <= cfg.nfft // 2 or T < cfg.hop:
        raise ValueError(f"{T} samples: Whisper's recipe reflects by "
                         f"{cfg.nfft // 2} at both ends and frames every "
                         f"{cfg.hop}, so a window needs more than "
                         f"{max(cfg.nfft // 2, cfg.hop - 1)}")


def reflect(n: torch.Tensor, T: int) -> torch.Tensor:
    """Sample index n of a window of T samples reflected at both ends (n ->
    -n below 0, n -> 2T - 2 - n from T), as K11's ingest addresses it."""
    n = torch.where(n < 0, -n, n)
    return torch.where(n >= T, 2 * T - 2 - n, n)


def frame_index(T: int, cfg: MFCCConfig, device) -> torch.Tensor:
    """(F, nfft) sample index of each frame's samples: frame f is sample
    f*hop - nfft/2 + i, reflected at both ends."""
    return reflect(torch.arange(cfg.n_frames(T), device=device)[:, None]
                   * cfg.hop - cfg.nfft // 2
                   + torch.arange(cfg.nfft, device=device)[None, :], T)


def silent_frames_plain(audio: torch.Tensor, cfg: MFCCConfig
                        ) -> torch.Tensor:
    """(..., T) -> (..., T // hop) bool: the frames whose nfft reflected
    samples (``frame_index``) are all zero (-0.0 is zero, NaN is not), the
    frames K11 takes on its silent path.  A running count of the nonzero
    samples of the reflect-padded window, so its memory is the window's."""
    T = audio.shape[-1]
    check_length(T, cfg)
    h = cfg.nfft // 2
    n = reflect(torch.arange(-h, T + h, device=audio.device), T)
    count = torch.nn.functional.pad(
        (audio[..., n] != 0).to(torch.int32).cumsum(-1), (1, 0))
    start = torch.arange(cfg.n_frames(T), device=audio.device) * cfg.hop
    return count[..., start + cfg.nfft] == count[..., start]


@functools.lru_cache(maxsize=None)
def silent_counter(device: torch.device) -> torch.Tensor:
    """The int64 on ``device`` (a CUDA device with its index) that K11's
    launches add their silent frames to."""
    count = torch.zeros((), dtype=torch.int64, device=device)
    torch.cuda.synchronize(device)     # zeroed before any stream's launch
    return count


def silent_frames(device) -> int:
    """The frames K11 took on its silent path on ``device`` since the
    process started; synchronizes the device.  0 on a CPU (the plain
    version has no silent path)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize(device)
    return int(silent_counter(device).item())


def log_mel_plain(audio: torch.Tensor, cfg: WhisperConfig,
                  operators: WhisperOperators | None = None
                  ) -> torch.Tensor:
    """K11 and K11-norm as plain torch ops: (..., T) -> (..., nfilters, T
    // hop) f32.  L = log10(max(mel power, 1e-10)) in float64 rounded to
    f32, then the window's max(L, max - 8) and (L + 4) / 4 in f32.  The
    recipe's route on the CPU and outside K11's family."""
    ops = operators or default_operators(cfg, audio.device)
    T = audio.shape[-1]
    check_length(T, cfg)
    lead = audio.shape[:-1]
    if not math.prod(lead):
        return torch.zeros(lead + (cfg.nfilters, cfg.n_frames(T)),
                           device=audio.device)
    x = audio.reshape(-1, T).to(torch.float64)
    idx = frame_index(T, cfg, audio.device)
    spec = torch.fft.rfft(x[:, idx] * ops.window, dim=-1)
    power = spec.real * spec.real + spec.imag * spec.imag
    L = torch.log10(torch.clamp_min(power @ ops.mel, cfg.log_floor))
    L = L.to(torch.float32).transpose(-1, -2)          # (B, nfilters, F)
    top = L.amax(dim=(-2, -1), keepdim=True)
    out = (torch.maximum(L, top - cfg.dynamic_range) + 4.0) * 0.25
    return out.reshape(lead + out.shape[-2:])


def fft_model(z: torch.Tensor) -> torch.Tensor:
    """K11's 200-point FFT in torch with the kernel's index formulas, on
    (..., 200) complex points: point m placed at its digit-reversed
    position 40 (m mod 5) + 8 ((m / 5) mod 5) + m / 25, then in place a
    stage of radix 8 (butterfly b on positions 8b + q), one of radix 5 on
    base 40 (b / 8) + b mod 8 + 8q with twiddles W_400^(10 j q), j = b mod
    8, and one on j + 40q with W_400^(2 j q), j = b; the row then holds
    the DFT in natural order.  The tests hold it to torch.fft.fft."""
    m = torch.arange(200)
    row = torch.empty_like(z)
    row[..., 40 * (m % 5) + 8 * ((m // 5) % 5) + m // 25] = z
    w400 = torch.polar(torch.ones(400, dtype=torch.float64),
                       -2.0 * math.pi
                       * torch.arange(400, dtype=torch.float64) / 400
                       ).to(z.dtype)

    def butterflies(pos, tw, r):
        q = torch.arange(r, dtype=torch.float64)
        k = q[:, None] * q[None, :]
        dft = torch.polar(torch.ones(r, r, dtype=torch.float64),
                          -2.0 * math.pi * k / r).to(z.dtype)
        v = row[..., pos] * tw                      # (..., nb, r)
        row[..., pos] = v @ dft

    b = torch.arange(25)[:, None]
    butterflies(8 * b + torch.arange(8), 1.0, 8)
    b, q = torch.arange(40)[:, None], torch.arange(5)[None, :]
    j = b % 8
    butterflies(40 * (b // 8) + j + 8 * q, w400[10 * j * q], 5)
    butterflies(b + 40 * q, w400[2 * b * q], 5)
    return row


def tiles_per_window(F: int) -> int:
    """Tiles of TILE_FRAMES frames in a window of F frames (the last one
    partial): the columns of the tile maxima K11 writes."""
    return -(-F // TILE_FRAMES)


def log_mel(audio: torch.Tensor, cfg: WhisperConfig,
            operators: WhisperOperators | None = None) -> torch.Tensor:
    """K11 then K11-norm: (..., T) int16 or f32 -> (..., nfilters, T //
    hop) f32.  On a CUDA tensor this launches both kernels or raises; a
    CPU tensor takes ``log_mel_plain``.  Nothing else runs on the card:
    the output and the (windows, tiles) f32 tile maxima are the call's
    only allocations (and, at a device's first call, its silent
    counter)."""
    global WHISPER_LAUNCHES, WHISPER_NORM_LAUNCHES, WHISPER_FRAMES
    if audio.device.type == "cpu":
        return log_mel_plain(audio, cfg, operators)
    if not config_ok(cfg):
        raise ValueError(f"config outside K11's family: {cfg}")
    if audio.device.type != "cuda":
        raise ValueError(f"K11 runs on CUDA or CPU tensors, got "
                         f"{audio.device}")
    if audio.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"K11 takes int16 or float32, got {audio.dtype}")
    if not audio.is_contiguous():
        raise ValueError("K11 needs a contiguous input")
    ops = operators or default_operators(cfg, audio.device)
    if ops.sched is None:
        raise ValueError("K11's operators have no mel schedule: the bank "
                         "weighs the Nyquist bin or overflows the table")
    T = audio.shape[-1]
    check_length(T, cfg)
    lead = audio.shape[:-1]
    B, F, nf = math.prod(lead), cfg.n_frames(T), cfg.nfilters
    out = torch.empty(lead + (nf, F), dtype=torch.float32,
                      device=audio.device)
    tmax = torch.empty((B, tiles_per_window(F)), dtype=torch.float32,
                       device=audio.device)
    lib = build.library()
    build.launch(lib.whisper_logmel, audio.device,
                 int(audio.dtype == torch.int16), audio.data_ptr(),
                 out.data_ptr(), tmax.data_ptr(), B, T, F, cfg.hop, nf,
                 ops.window.data_ptr(), ops.twiddles.data_ptr(),
                 ops.sched.data_ptr(), ops.steps,
                 silent_counter(audio.device).data_ptr())
    WHISPER_LAUNCHES += 1
    WHISPER_FRAMES += B * F
    build.launch(lib.whisper_norm, audio.device, out.data_ptr(),
                 tmax.data_ptr(), B, nf, F, tmax.shape[1],
                 float(cfg.dynamic_range))
    WHISPER_NORM_LAUNCHES += 1
    return out
