"""The feature-extractor model family as ``nn.Module``s.

The counterpart of ``mfcc_tpu.models.features``.  The reference ships one
model (the 8-stage MFCC core) with two deployed configurations -- wav2mfcc
(USB3, 32 cepstra, wav2mfcc.py:19) and mic2mfcc (UART, 16 cepstra,
mic2mfcc.py:19).  Every truncation of the pipeline is a usable feature
extractor, each a module whose tables are buffers (``load_numpy_operators``
replaces them), plus the librosa-recipe variant used for goldens.

The float models run the ``float_ops`` chain (matmuls and log2, TF32 off),
as the JAX models run their XLA chain, so autograd flows through them end
to end: they double as trainable front-ends.  ``IntMFCCFeatures`` is
``MFCC.int``: K2 on the card, the element-exact INT chain on the CPU.

``device=None`` is the card, as for ``MFCC``; ``device="cpu"`` runs on the
host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import tables
from ..config import DEFAULT_CONFIG, MIC_CONFIG, MFCCConfig
from ..ops import float_ops, framing
from ..pipeline import MFCC, resolve_device

_STATE = ("window", "mel", "dct")    # the tables a caller may replace


def _as_input(x, device: torch.device) -> torch.Tensor:
    """A tensor must lie on the model's device (nothing is moved behind the
    caller's back); numpy arrays and lists are put there."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(
                f"input is on {x.device} but the model's tables are on "
                f"{device}: move one of them with .to()")
        return x
    return torch.as_tensor(np.asarray(x), device=device)


class _FloatModel(nn.Module):
    """Shared scaffolding: raw (..., T) audio -> features on the chain."""

    def __init__(self, cfg: MFCCConfig = DEFAULT_CONFIG, *,
                 precision: str = "highest",
                 dtype: torch.dtype = torch.float32, mel_floor: float = 0.0,
                 device=None):
        super().__init__()
        device = resolve_device(device, type(self).__name__)
        float_ops._check_precision(precision)
        self.cfg = cfg
        self.precision = precision
        self.dtype = dtype
        self.mel_floor = mel_floor
        for name, value in float_ops.operators_np(cfg).items():
            self.register_buffer(name, torch.as_tensor(value, dtype=dtype,
                                                       device=device))

    def load_numpy_operators(self, arrays: dict) -> None:
        """Replace any of the ``window`` (nfft,), ``mel`` (nfft/2+1,
        nfilters) and ``dct`` (nfilters, nceptrums) tables with numpy
        arrays (the JAX package's tables, say); the windowed DFT is rebuilt
        from the window."""
        unknown = set(arrays) - set(_STATE)
        if unknown:
            raise ValueError(f"unknown operators {sorted(unknown)}")
        current = {k: getattr(self, k).detach().cpu().numpy() for k in _STATE}
        for name, value in arrays.items():
            value = np.asarray(value, np.float64)
            if value.shape != current[name].shape:
                raise ValueError(f"{name}: shape {value.shape}, expected "
                                 f"{current[name].shape}")
            current[name] = value
        for name, value in float_ops.operators_np(self.cfg, **current).items():
            getattr(self, name).copy_(torch.as_tensor(value))

    def operators(self) -> float_ops.Operators:
        return float_ops.Operators(self.window, self.dft, self.mel, self.dct)

    def _frames(self, audio: torch.Tensor) -> torch.Tensor:
        emph = framing.preemphasis(audio.to(self.dtype))
        return framing.extract_frames(emph, self.cfg.nfft, self.cfg.hop,
                                      windowlen=self.cfg.windowlen)

    def forward(self, audio) -> torch.Tensor:
        return self._fn(_as_input(audio, self.window.device))


class Spectrogram(_FloatModel):
    """(..., T) -> (..., F, nfft/2+1) power spectrogram |fft(w*x)/nfft|^2."""

    def _fn(self, audio):
        return float_ops.power_spectrum_frames(
            self._frames(audio), self.cfg, precision=self.precision,
            dtype=self.dtype, operators=self.operators())


class MelSpectrogram(_FloatModel):
    """(..., T) -> (..., F, nfilters) triangular-mel energies (no log)."""

    def _fn(self, audio):
        power = float_ops.power_spectrum_frames(
            self._frames(audio), self.cfg, precision=self.precision,
            dtype=self.dtype, operators=self.operators())
        return float_ops.mel_product(power, self.mel, self.precision)


class LogMelSpectrogram(_FloatModel):
    """(..., T) -> (..., F, nfilters) log2 mel energies."""

    def _fn(self, audio):
        return float_ops.log_mel_frames(
            self._frames(audio), self.cfg, precision=self.precision,
            dtype=self.dtype, mel_floor=self.mel_floor,
            operators=self.operators())


class MFCCFeatures(_FloatModel):
    """(..., T) -> (..., F, nceptrums), the flagship float model."""

    def _fn(self, audio):
        return float_ops.mfcc_batch(audio, self.cfg,
                                    precision=self.precision,
                                    dtype=self.dtype,
                                    mel_floor=self.mel_floor,
                                    operators=self.operators())


class IntMFCCFeatures(nn.Module):
    """Bit-exact fixed-point MFCC (the RTL's numerics), (..., T) int ->
    (..., F, nceptrums) int32: ``MFCC(cfg).int``."""

    def __init__(self, cfg: MFCCConfig = DEFAULT_CONFIG, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.mfcc = MFCC(cfg, device=resolve_device(device,
                                                    "IntMFCCFeatures"))

    def forward(self, audio) -> torch.Tensor:
        return self.mfcc.int(audio)


class LibrosaMFCC(nn.Module):
    """The golden recipe (``compat.librosa_mfcc``) on tensors: n_fft=2048,
    center reflect pad, hann, slaney mel(128), power_to_db, DCT ortho.
    (..., T) float or integer (taken as int16 samples, / 32768) ->
    (..., n_mfcc, F), librosa's layout."""

    def __init__(self, sr: int = 16000, n_mfcc: int = 32, hop: int = 170,
                 n_fft: int = 2048, n_mels: int = 128,
                 dtype: torch.dtype = torch.float32, device=None):
        from ..compat import librosa_mfcc as lr
        super().__init__()
        device = resolve_device(device, "LibrosaMFCC")
        self.sr, self.n_mfcc, self.hop, self.n_fft = sr, n_mfcc, hop, n_fft
        self.dtype = dtype
        # constants come from the compat recipe (the single golden source)
        tabs = dict(
            win=lr.hann_window(n_fft),
            mel=lr.mel_filterbank(sr, n_fft, n_mels).T,
            dct=tables.dct2_ortho_matrix(n_mels)[:, :n_mfcc])
        for name, value in tabs.items():
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(value), dtype=dtype, device=device))

    def forward(self, y) -> torch.Tensor:
        y = _as_input(y, self.win.device)
        if not y.is_floating_point():
            y = y.to(torch.float32) / 32768.0
        y = y.to(self.dtype)
        lead, T = y.shape[:-1], y.shape[-1]
        n_fft, hop = self.n_fft, self.hop
        y = F.pad(y.reshape(-1, T), (n_fft // 2, n_fft // 2), mode="reflect")
        frames = y.unfold(-1, n_fft, hop) * self.win
        spec = torch.fft.rfft(frames, dim=-1)
        S = (spec.real ** 2 + spec.imag ** 2).to(self.dtype)
        db = 10.0 * torch.log10(torch.clamp_min(S @ self.mel, 1e-10))
        top = db.amax(dim=(-2, -1), keepdim=True)
        db = torch.maximum(db, top - 80.0)
        out = (db @ self.dct).transpose(-1, -2)
        return out.reshape(lead + out.shape[-2:])


# Deployed configurations of the reference targets:
def wav2mfcc_model(device=None) -> MFCCFeatures:
    """The USB3 batch target config (wav2mfcc.py:19): 32 cepstra."""
    return MFCCFeatures(DEFAULT_CONFIG, device=device)


def mic2mfcc_model(device=None) -> MFCCFeatures:
    """The live mic/UART target config (mic2mfcc.py:19): 16 cepstra."""
    return MFCCFeatures(MIC_CONFIG, device=device)
