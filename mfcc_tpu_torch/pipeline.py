"""Public batch API: the MFCC feature extractor as an ``nn.Module``.

The counterpart of ``mfcc_tpu.pipeline.MFCC``.  The module's operators live
on the card (``device="cuda"`` by default) unless the caller asks for the
CPU with ``device="cpu"``.  Routing mirrors the JAX package route for
route.  Float path (``forward``, ``frames``):

  * ``method="dft"``, float32, ``precision="highest"`` and a config in K1's
    family (``ops.fladder.fladder_config_ok``) -> K1, the fused kernel
    (launched for CUDA tensors; its plain torch version for CPU tensors);
  * the cases the JAX package sends to its split-DFT / recompute kernels
    (``method="dft"``, float32, no ``mel_floor``, a config in
    ``ops.float_fused.float_config_ok``): ``precision="fast"`` with an even
    hop -> K5 at 3 passes (``float_fused.mfcc_radix2``), and
    ``precision="highest"`` with an odd hop -> K6
    (``float_fused.mfcc_recomp_t``, on K1's kernel), for CUDA tensors; CPU
    tensors take the "highest" ``float_ops`` chain, which is what the JAX
    package computes off its accelerator;
  * ``frames`` under ``precision="fast"`` in that family -> K5-frames at 3
    passes (``float_fused.mfcc_frames_float``) for CUDA tensors, the chain
    for CPU tensors;
  * ``precision="f64ish"`` (``method``, ``dtype`` and ``mel_floor``
    ignored, as in JAX): ``forward`` -> K7 (``f64ish.mfcc_f64ish``) and
    ``frames`` -> K7-frames (``f64ish.mfcc_f64ish_frames``) for a config in
    ``f64ish.f64ish_config_ok``, launched for CUDA tensors, their plain
    versions for CPU tensors; other configs -> the float64 chain;
  * everything else, ``precision="split"`` included -> the ``float_ops``
    chain, as in JAX.

INT path (``int``, ``int_frames``): a config in the fused kernels' family
(``ops.int_fused.int_config_ok``) -> K2 / K3 (launched for CUDA tensors;
their plain versions for CPU tensors); every other config (width != 16,
odd hop, nfilters not 16 or 32, windowlen != nfft) -> the ``int_ops``
chain, as in JAX.

Layouts are the JAX package's: (..., T) in, (..., F, nceptrums) out.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import tables
from .config import MFCCConfig
from .ops import f64ish, fladder, float_fused, float_ops, int_fused, int_ops

_STATE = ("window", "mel", "dct")    # the module's state_dict
PRECISIONS = ("highest", "fast", "split", "f64ish")   # ported to the modules


def resolve_device(device, what: str) -> torch.device:
    """An entry point's device: ``None`` is the card (the current CUDA
    device) and raises on a host without one, naming ``device="cpu"``;
    anything else is taken as given, a CUDA device without an index as the
    current one (so that it compares equal to its tensors' device)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what}() runs on the CUDA card by default and this host "
                "has none (torch.cuda.is_available() is false): pass "
                "device=\"cpu\" to run on the host")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_precision(precision: str) -> None:
    """Raise ``NotImplementedError`` for a precision the modules do not
    run (``"high"``, ``"default"`` and ``"bf16"`` wait for a decision)."""
    if precision not in PRECISIONS:
        raise NotImplementedError(
            f"precision={precision!r} is not ported to the torch package "
            "(high, default and bf16 wait for a decision)")


def _rederive(module: "MFCC", incompatible_keys) -> None:
    """load_state_dict post-hook: rebuild the derived operators."""
    module._derive()


class MFCC(nn.Module):
    """Batched MFCC front-end.

    >>> fe = MFCC()                       # defaults = wav2mfcc target config
    >>> cep = fe(audio_batch)             # float path, (S, T) -> (S, F, 32)
    >>> cep_int = fe.int(audio_batch)     # bit-exact INT path, int32
    """

    def __init__(self, cfg: MFCCConfig = MFCCConfig(), *,
                 method: str = "dft", precision: str = "highest",
                 dtype: torch.dtype = torch.float32, mel_floor: float = 0.0,
                 device=None):
        """``precision`` is ``"highest"`` (the 5e-4 float contract),
        ``"fast"``: the 3-pass split-DFT kernel K5 (the JAX package's fast
        mode, ~1e-3 against the float64 oracle on short inputs) where the
        JAX package runs it, the "highest" chain elsewhere; ``"f64ish"``:
        the max(1e-5, 2 ulp) contract in FP64 (K7); or ``"split"``: the
        chain with a split-bf16 DFT matmul.  ``"high"``, ``"default"`` and
        ``"bf16"`` are not ported.

        ``device`` is where the operators live and the work runs:
        ``None`` is the card (``"cuda"``, the current CUDA device), and
        raises on a host without one; ``device="cpu"`` runs the plain
        torch versions on the host."""
        super().__init__()
        device = resolve_device(device, "MFCC")
        check_precision(precision)
        self.cfg = cfg
        self.method = method
        self.precision = precision
        self.dtype = dtype
        self.mel_floor = mel_floor

        fast = precision == "fast"
        # the JAX package's split-DFT family: pallas_mfcc.pallas_float_config_ok
        fused_ok = (method == "dft" and dtype == torch.float32
                    and mel_floor == 0.0 and float_fused.float_config_ok(cfg))
        # the route of CUDA tensors; CPU tensors take the chain outside K1's
        # and K7's
        if precision == "f64ish":
            self._route = "f64ish"          # K7, or the float64 chain
        elif (method == "dft" and dtype == torch.float32
                and precision == "highest" and fladder.fladder_config_ok(cfg)):
            self._route = "ladder"
        elif fused_ok and fast and cfg.hop % 2 == 0:
            self._route = "radix2"          # K5, 3 passes
        elif fused_ok and precision == "highest" and cfg.hop % 2:
            self._route = "recomp_t"        # K6
        else:
            self._route = "chain"
        self._frames_route = ("f64ish" if precision == "f64ish" else
                              "radix2" if fast and fused_ok else "chain")
        self._int_route = "fused" if int_fused.int_config_ok(cfg) else "chain"

        # float64 buffers: K1 computes in float64; the chain casts them to
        # its working dtype per call.  Only window, mel and dct are state;
        # the DFT operator, K1's window/nfft and the mel band limits are
        # derived from them, and rebuilt whenever they change
        # (load_numpy_operators, load_state_dict).
        ops = float_ops.operators_np(cfg)
        for name in _STATE:
            self.register_buffer(name, torch.as_tensor(
                ops[name], dtype=torch.float64, device=device))
        for name in ("dft", "ladder_window", "mel_band"):
            self.register_buffer(name, None, persistent=False)
        self.register_load_state_dict_post_hook(_rederive)
        self._derive()

    def _derive(self) -> None:
        nfft = self.cfg.nfft
        C, S = tables.windowed_rdft_matrix(
            nfft, window=self.window.detach().cpu().numpy())
        self.dft = torch.as_tensor(np.concatenate([C, S], axis=1),
                                   dtype=torch.float64,
                                   device=self.window.device)
        self.ladder_window = self.window / nfft
        self.mel_band = fladder.mel_bands(self.mel[: nfft // 2])

    def load_numpy_operators(self, arrays: dict) -> None:
        """Replace the operators with numpy arrays: any of ``window``
        (nfft,), ``mel`` (nfft/2+1, nfilters) and ``dct`` (nfilters,
        nceptrums); the derived operators are rebuilt in float64.  Values
        keep the buffers' device."""
        unknown = set(arrays) - set(_STATE)
        if unknown:
            raise ValueError(f"unknown operators {sorted(unknown)}")
        arrays = {k: np.asarray(v, np.float64) for k, v in arrays.items()}
        for name, value in arrays.items():
            shape = tuple(getattr(self, name).shape)
            if value.shape != shape:
                raise ValueError(f"{name}: shape {value.shape}, "
                                 f"expected {shape}")
        for name, value in arrays.items():
            getattr(self, name).copy_(torch.as_tensor(value))
        self._derive()

    def _ladder_ops(self) -> fladder.LadderOperators:
        """K1's (and K6's) operators, from the module's state."""
        return fladder.LadderOperators(
            self.ladder_window, self.mel[: self.cfg.nfft // 2], self.dct,
            self.mel_band)

    def _radix2_ops(self) -> float_fused.Radix2Operators:
        """K5's operators: the window, mel and dct from the module's state
        (f32), the DFT tables and twiddles from the config."""
        nh = self.cfg.nfft // 2
        ops = float_fused.default_operators(self.cfg, self.window.device)
        return ops._replace(
            we=self.window[0::2].float().contiguous(),
            wo=self.window[1::2].float().contiguous(),
            mel=self.mel[:nh].float().contiguous(),
            dct=self.dct.float().contiguous(), band=self.mel_band)

    def _chain_ops(self, dtype=None) -> float_ops.Operators:
        dtype = dtype or self.dtype
        return float_ops.Operators(*(getattr(self, name).to(dtype)
                                     for name in float_ops.Operators._fields))

    def _f64ish_ops(self):
        """K7's operators (K1's) in its family, else the float64 chain's."""
        if f64ish.f64ish_config_ok(self.cfg):
            return self._ladder_ops()
        return self._chain_ops(torch.float64)

    @property
    def _chain_precision(self) -> str:
        """The chain's precision: "split" stays, "fast" runs "highest"."""
        return "split" if self.precision == "split" else "highest"

    def _as_input(self, x) -> torch.Tensor:
        """A tensor must lie on the operators' device (as in any
        ``nn.Module``, nothing is moved behind the caller's back); numpy
        arrays and lists are put there."""
        device = self.window.device
        if isinstance(x, torch.Tensor):
            if x.device != device:
                raise ValueError(
                    f"input is on {x.device} but the module's operators are "
                    f"on {device}: move one of them with .to()")
            return x
        return torch.as_tensor(x, device=device)

    # -- float path ----------------------------------------------------------

    def forward(self, audio) -> torch.Tensor:
        """(..., T) raw samples -> (..., F, nceptrums) float cepstra."""
        audio = self._as_input(audio)
        if self._route == "f64ish":
            return f64ish.mfcc_batch_f64ish(audio, self.cfg,
                                            operators=self._f64ish_ops())
        if self._route == "ladder":
            if audio.dtype != torch.int16:
                audio = audio.to(torch.float32)   # never truncated to int16
            return fladder.mfcc_float_ladder(
                audio.contiguous(), self.cfg, self.mel_floor,
                operators=self._ladder_ops())
        if self._route != "chain" and audio.device.type != "cpu":
            if self._route == "radix2":
                return float_fused.mfcc_radix2(audio, self.cfg, dft_passes=3,
                                               operators=self._radix2_ops())
            return float_fused.mfcc_recomp_t(
                audio, self.cfg, operators=self._ladder_ops())
        return float_ops.mfcc_batch(
            audio, self.cfg, method=self.method,
            precision=self._chain_precision, dtype=self.dtype,
            mel_floor=self.mel_floor, operators=self._chain_ops())

    def frames(self, frames) -> torch.Tensor:
        """(..., F, nfft) pre-emphasized frames -> (..., F, nceptrums)."""
        frames = self._as_input(frames)
        if self._frames_route == "f64ish":
            return f64ish.mfcc_frames_f64ish(frames, self.cfg,
                                             operators=self._f64ish_ops())
        if self._frames_route == "radix2" and frames.device.type != "cpu":
            return float_fused.mfcc_frames_float(
                frames, self.cfg, dft_passes=3, operators=self._radix2_ops())
        return float_ops.mfcc_frames(
            frames, self.cfg, method=self.method,
            precision=self._chain_precision, dtype=self.dtype,
            mel_floor=self.mel_floor, operators=self._chain_ops())

    # -- INT path (bit-exact RTL parity) ---------------------------------------

    def _as_int(self, x) -> torch.Tensor:
        """As ``jnp.asarray(np.asarray(x), dtype=jnp.int32)`` in the JAX
        package: float input is truncated toward zero, other integers are
        taken as int32.  int16 stays int16 (its values are the same int32
        values, and it is K2's wire type)."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        x = self._as_input(x)
        if x.dtype not in (torch.int16, torch.int32):
            x = x.to(torch.int32)
        return x.contiguous()

    def int(self, audio) -> torch.Tensor:
        """(..., T) int16-range samples -> (..., F, nceptrums) int32
        cepstra, element-exact vs the RTL fixed-point pipeline.  The
        kernels' route takes samples mod 2^16 (the int16 wire contract)."""
        x = self._as_int(audio)
        if self._int_route == "fused":
            return int_fused.mfcc_int_fused(x, self.cfg)
        return int_ops.mfcc_int_batch(x, self.cfg)

    def int_frames(self, frames) -> torch.Tensor:
        """(..., F, nfft) pre-emphasized int frames -> (..., F, nceptrums)
        int32."""
        x = self._as_int(frames).to(torch.int32)
        if self._int_route == "fused":
            return int_fused.mfcc_int_fused_frames(x, self.cfg)
        return int_ops.mfcc_int_frames(x, self.cfg)
