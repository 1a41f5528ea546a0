"""K12 and K12-cmvn: SeamlessM4T's fbank (``config.SeamlessFbankConfig``,
Hugging Face's ``SeamlessM4TFeatureExtractor``) on ragged batches on the
card.

(B, T) int16 or f32 samples in int16's scale, zero-padded at the end, and
(B,) lengths -> (features (B, F_pad / 2, 2 nfilters) f32, attention mask
(B, F_pad / 2) int32), in two launches of one C entry
(``csrc/seamless_fbank.cu`` ``seamless_fbank``):

* K12, ``fbank_walk``: the FP64 walk of K1-Kaldi (Kaldi's ingest and the
  tail's FFT, power and balanced mel schedule in ``fladder_stages.cuh``)
  over the utterances' own frames only, a ragged work list of frame G ->
  (utterance s, frame G - starts[s]) by a search of ``starts``, the
  frames' exclusive prefix sum; it stores each frame's ln(max(E,
  FLT_EPSILON)) in FP64, no DCT, to an (own frames, nfilters) row;
* K12-cmvn, ``fbank_cmvn``: a block an utterance and 16 bins, the bins'
  mean and unbiased variance over the utterance's own frames in FP64
  (Welford's update a thread, Chan's merge across threads, never a
  difference of running sums), (L - mean) / sqrt(var + 1e-7) rounded to
  f32 once, exact zeros in the padding, written frame-major into (B,
  F_pad, nfilters), which the stacking reads as (B, F_pad / 2, 2
  nfilters); the blocks of the first 16 bins write the mask.

``fbank`` is the wrapper: a CUDA tensor launches both (or the wrapper
raises), a CPU tensor takes ``fbank_plain``, the same function as a chain
of float64 torch ops.  The lengths are read on the host (a CUDA tensor of
them is copied back first): they fix F_pad, the output's shape.
``FBANK_LAUNCHES`` and ``CMVN_LAUNCHES`` count the two kernels' launches,
``FBANK_FRAMES`` the frames K12 computed, the utterances' own.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import tables
from ..config import MFCCConfig, SeamlessFbankConfig
from ..kernels import build
from . import fladder, framing

FBANK_LAUNCHES = 0    # K12 launches by fbank (never the plain path)
CMVN_LAUNCHES = 0     # K12-cmvn launches by fbank
FBANK_FRAMES = 0      # frames those K12 launches computed

NFFT = 512            # K12's instantiation (nfft 512, 8 points a lane)


class FbankOperators(NamedTuple):
    """The recipe's tables on one device, float64 (band int32)."""
    window: torch.Tensor    # (nfft,) the povey window, zero-padded
    mel: torch.Tensor       # (nfft/2, nfilters) Kaldi's bank below Nyquist
    band: torch.Tensor      # (nfilters, 2) fladder.mel_bands(mel)


def refuse(cfg: MFCCConfig, entry: str) -> None:
    """Raise for an entry that SeamlessM4T's fbank does not define."""
    if cfg.recipe == "seamless":
        raise ValueError(
            f"SeamlessM4T's fbank has no {entry}: it normalises each mel "
            "bin over the whole utterance, so it is defined on whole "
            "utterances only; call MFCC(cfg)(audio, lengths)")


def operators_np(cfg: SeamlessFbankConfig) -> tuple[np.ndarray, ...]:
    """(window, mel) as the module's buffers hold them: the povey window
    zero-padded to nfft (no 1/nfft: the power is unscaled) and the bank
    with the zero Nyquist row of the (nfft/2 + 1) shape."""
    win = np.zeros(cfg.nfft)
    win[: cfg.windowlen] = tables.povey_window(cfg.windowlen)
    mel = tables.seamless_mel_matrix(cfg.samplerate, cfg.nfft, cfg.nfilters)
    return win, np.concatenate([mel, np.zeros((1, cfg.nfilters))])


def make_operators(window: torch.Tensor, mel: torch.Tensor
                   ) -> FbankOperators:
    """The operators of a window (nfft,) and a bank (nfft/2 + 1,
    nfilters), float64 on one device; the Nyquist row is left out."""
    nh = window.shape[0] // 2
    mel = mel.detach()[:nh].to(torch.float64).contiguous()
    return FbankOperators(window.detach().to(torch.float64).contiguous(),
                          mel, fladder.mel_bands(mel))


@functools.lru_cache(maxsize=None)
def default_operators(cfg: SeamlessFbankConfig, device: torch.device
                      ) -> FbankOperators:
    win, mel = (torch.as_tensor(a, device=device) for a in operators_np(cfg))
    return make_operators(win, mel)


def frame_counts(lengths, B: int, T: int, cfg: MFCCConfig) -> np.ndarray:
    """(B,) int64 frames of each utterance, F = 1 + (n - 400) // 160, from
    ``lengths`` (None: every row's T samples); raises for a length under
    ``cfg.min_samples`` (F < 2: no unbiased variance) or over T."""
    if lengths is None:
        n = np.full(B, T, np.int64)
    else:
        if isinstance(lengths, torch.Tensor):
            lengths = lengths.detach().cpu().numpy()
        n = np.asarray(lengths)
        if n.shape != (B,) or not np.issubdtype(n.dtype, np.integer):
            raise ValueError(f"lengths must be {B} whole numbers, one an "
                             f"utterance; got {n.dtype} {n.shape}")
        n = n.astype(np.int64)
    if B and (n.min() < cfg.min_samples or n.max() > T):
        raise ValueError(
            f"utterances of {n.min()} to {n.max()} samples in rows of {T}: "
            f"each needs {cfg.min_samples} to T (two frames, since the "
            "unbiased variance needs two)")
    return (n - cfg.windowlen) // cfg.hop + 1


def padded_frames(counts: np.ndarray, cfg: MFCCConfig) -> int:
    """F_pad: the longest utterance's frames rounded up to the stride."""
    s = cfg.stride
    return -(-int(counts.max(initial=0)) // s) * s


def _as_batch(audio: torch.Tensor) -> torch.Tensor:
    if audio.dim() == 1:
        return audio[None]
    if audio.dim() != 2:
        raise ValueError(f"SeamlessM4T's fbank takes (B, T) or (T,) audio, "
                         f"got {tuple(audio.shape)}")
    return audio


def fbank_plain(audio: torch.Tensor, lengths, cfg: SeamlessFbankConfig,
                operators: FbankOperators | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """K12 and K12-cmvn as plain torch ops in float64: the frames of each
    row up to F_pad, Kaldi's DC removal and emphasis, the window, the FFT,
    power, mel, floor and ln, then each bin's mean and unbiased variance
    over the utterance's own frames, the normalised value rounded to f32
    once, zeros past them and the stacking.  The recipe's route on the
    CPU."""
    ops = operators or default_operators(cfg, audio.device)
    x = _as_batch(audio)
    B, T = x.shape
    counts = frame_counts(lengths, B, T, cfg)
    Fp, nf, s = padded_frames(counts, cfg), cfg.nfilters, cfg.stride
    out = torch.zeros((B, Fp, nf), dtype=torch.float32, device=x.device)
    if B:
        Fmax = int(counts.max())
        frames = x.to(torch.float64).unfold(-1, cfg.windowlen,
                                            cfg.hop)[:, :Fmax]
        y = framing.kaldi_preemphasis(frames, cfg.preemphasis_coefficient)
        y = torch.nn.functional.pad(y, (0, cfg.nfft - cfg.windowlen))
        spec = torch.fft.rfft(y * ops.window, dim=-1)[..., : cfg.nfft // 2]
        power = spec.real * spec.real + spec.imag * spec.imag
        L = torch.log(torch.clamp_min(power @ ops.mel, tables.FLT_EPSILON))
        F = torch.as_tensor(counts, device=x.device)[:, None, None]
        own = torch.arange(Fmax, device=x.device)[None, :, None] < F
        mean = torch.where(own, L, 0.0).sum(1, keepdim=True) / F
        d = torch.where(own, L - mean, 0.0)
        var = (d * d).sum(1, keepdim=True) / (F - 1)
        out[:, :Fmax] = (d / torch.sqrt(var + cfg.variance_floor)).to(
            torch.float32)
    mask = (torch.arange(s - 1, Fp, s, device=x.device)[None, :]
            < torch.as_tensor(counts, device=x.device)[:, None])
    return out.reshape(B, Fp // s, s * nf), mask.to(torch.int32)


def fbank(audio: torch.Tensor, lengths, cfg: SeamlessFbankConfig,
          operators: FbankOperators | None = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """K12 then K12-cmvn: (B, T) int16 or f32 and (B,) lengths ->
    (features (B, F_pad / 2, 2 nfilters) f32, mask (B, F_pad / 2) int32).
    On a CUDA tensor this launches both kernels or raises; a CPU tensor
    takes ``fbank_plain``.  On the card the call holds the output, the
    mask, the (own frames, nfilters) float64 log-mel between the kernels
    and the (B + 1) frame offsets, copied from pinned memory without a
    synchronization."""
    global FBANK_LAUNCHES, CMVN_LAUNCHES, FBANK_FRAMES
    if audio.device.type == "cpu":
        return fbank_plain(audio, lengths, cfg, operators)
    if cfg.recipe != "seamless":     # nfft 512; every bin count's schedule
        raise ValueError(f"config outside K12's family: {cfg}")
    if audio.device.type != "cuda":
        raise ValueError(f"K12 runs on CUDA or CPU tensors, got "
                         f"{audio.device}")
    if audio.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"K12 takes int16 or float32, got {audio.dtype}")
    if not audio.is_contiguous():
        raise ValueError("K12 needs a contiguous input")
    x = _as_batch(audio)
    B, T = x.shape
    counts = frame_counts(lengths, B, T, cfg)
    Fp, nf, s = padded_frames(counts, cfg), cfg.nfilters, cfg.stride
    starts = np.zeros(B + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    own = int(starts[-1])
    dev = x.device
    out = torch.empty((B, Fp, nf), dtype=torch.float32, device=dev)
    mask = torch.empty((B, Fp // s), dtype=torch.int32, device=dev)
    if B == 0:
        return out.reshape(B, Fp // s, s * nf), mask
    starts = torch.from_numpy(starts).pin_memory().to(dev, non_blocking=True)
    lnmel = torch.empty((own, nf), dtype=torch.float64, device=dev)
    ops = operators or default_operators(cfg, dev)
    sched, steps = fladder.schedule_of(ops.mel)
    build.launch(build.library().seamless_fbank, dev,
                 int(x.dtype == torch.int16), x.data_ptr(),
                 lnmel.data_ptr(), out.data_ptr(), mask.data_ptr(),
                 starts.data_ptr(), B, T, Fp, own, cfg.hop, cfg.nfft,
                 cfg.windowlen, cfg.preemphasis_coefficient, nf,
                 ops.window.data_ptr(), fladder.twiddles(NFFT, dev).data_ptr(),
                 ops.mel.data_ptr(), ops.band.data_ptr(),
                 None if sched is None else sched.data_ptr(), steps,
                 tables.FLT_EPSILON, cfg.variance_floor)
    FBANK_LAUNCHES += 1
    CMVN_LAUNCHES += 1
    FBANK_FRAMES += own
    return out.reshape(B, Fp // s, s * nf), mask
