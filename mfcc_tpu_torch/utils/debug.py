"""Observability: per-stage intermediate dumps and profiler hooks.

The counterpart of ``mfcc_tpu.utils.debug``.  The reference taps every
stage's stream with passive collector processes (gen_collector,
mfcc/core/mfcc.py:128-141) and embeds a LiteScope logic analyzer
(mfcc/debug/scope.py).  Here: the float and INT chains with every stage
output returned in a dict (the same ten keys as the JAX package), and a
``torch.profiler`` trace in place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch

from .. import tables
from ..config import FILTERBANK_WIDTH, MFCCConfig
from ..ops import framing, int_ops


def _tensor(audio, device=None) -> torch.Tensor:
    if isinstance(audio, torch.Tensor):
        return audio if device is None else audio.to(device)
    return torch.as_tensor(np.asarray(audio), device=device or "cpu")


def float_intermediates(audio, cfg: MFCCConfig = MFCCConfig(), *,
                        dtype: torch.dtype = torch.float32) -> dict:
    """All float-path stage outputs: the 9-stage chain the reference's
    simulator collects (mfcc/core/mfcc.py:171-183), on ``audio``'s device
    (numpy goes to the CPU)."""
    x = _tensor(audio).to(dtype)
    emph = framing.preemphasis(x)
    frames = framing.extract_frames(emph, cfg.nfft, cfg.hop,
                                    windowlen=cfg.windowlen)
    win = frames * torch.as_tensor(tables.float_window(cfg.nfft),
                                   dtype=dtype, device=x.device)
    spec = torch.fft.rfft(win, dim=-1) / cfg.nfft
    spec_re = spec.real.to(dtype)
    spec_im = spec.imag.to(dtype)
    power = spec_re ** 2 + spec_im ** 2
    mel = power @ torch.as_tensor(
        tables.float_mel_matrix(cfg.samplerate, cfg.nfft, cfg.nfilters),
        dtype=dtype, device=x.device)
    logmel = torch.log2(mel)
    cep = logmel @ torch.as_tensor(tables.dct2_ortho_matrix(cfg.nfilters),
                                   dtype=dtype, device=x.device)
    return dict(emph=emph, frames=frames, window=win, fft_re=spec_re,
                fft_im=spec_im, power=power, filterbank=mel, log=logmel,
                dct=cep, cepstra=cep[..., : cfg.nceptrums])


def int_intermediates(audio, cfg: MFCCConfig = MFCCConfig()) -> dict:
    """All INT-path stage outputs (the same taps, fixed-point), on
    ``audio``'s device (numpy goes to the CPU)."""
    x = _tensor(audio).to(torch.int32)
    emph = framing.preemphasis_int(x, width=cfg.width)
    frames = framing.extract_frames(emph, cfg.nfft, cfg.hop,
                                    windowlen=cfg.windowlen)
    win = int_ops.window_int(frames, cfg.nfft, cfg.window_precision,
                             cfg.width)
    re, im = int_ops.fft_stream_int(win, cfg.width)
    power = int_ops.power_int(re, im, cfg.width, cfg.power_width)
    mel = int_ops.filterbank_int(power, cfg.samplerate, cfg.nfft,
                                 cfg.nfilters, cfg.filter_wsize,
                                 cfg.filter_gain, FILTERBANK_WIDTH,
                                 cfg.power_width)
    logmel = int_ops.log2fix_int(mel, FILTERBANK_WIDTH, cfg.log_width_output)
    cep = int_ops.dct_int(logmel, cfg.width)
    return dict(emph=emph, frames=frames, window=win, fft_re=re, fft_im=im,
                power=power, filterbank=mel, log=logmel, dct=cep,
                cepstra=cep[..., : cfg.nceptrums])


@contextlib.contextmanager
def profile_trace(logdir: str | None = None):
    """A ``torch.profiler`` trace of the block, the LiteScope equivalent:
    the card's activity (CUDA) on a host with a card, the CPU's otherwise.
    On exit the trace is written to ``<logdir>/trace.json`` (Chrome trace
    format: chrome://tracing, Perfetto); ``logdir`` defaults to
    ``mfcc_tpu_torch_trace`` in the temporary directory.  Yields the
    directory."""
    from torch.profiler import ProfilerActivity, profile
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "mfcc_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activity = (ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU)
    with profile(activities=[activity]) as prof:
        yield logdir
        if activity == ProfilerActivity.CUDA:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
