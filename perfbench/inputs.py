"""Inputs from ``--seed``: the JAX package's bench signal (a chirp and a tone
shared by every stream, plus uniform noise per stream), as ``chip_smoke.py``
``make_audio`` builds it, made on the card for the batch and streaming cells
and in numpy for the load generator's clients.  This module imports numpy
only (the client process imports it); ``card_audio`` imports torch when
called."""

from __future__ import annotations

import hashlib

import numpy as np

RATE = 16000


def subseed(seed: int, *salt) -> int:
    """A 63-bit seed for one use of ``seed`` (any whole number, negative or
    past 64 bits included)."""
    text = ":".join(str(s) for s in (seed, *salt)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def _base(t: np.ndarray) -> np.ndarray:
    return (9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
            + 4000 * np.sin(2 * np.pi * 900 * t))


def client_audio(seed: int, client: int, n_samples: int) -> np.ndarray:
    """(n_samples,) int16: one client's signal (its noise drawn from
    ``seed`` and its index)."""
    rng = np.random.default_rng(subseed(seed, "client", client))
    t = np.arange(n_samples) / RATE
    noise = rng.integers(-1500, 1500, n_samples)
    return np.clip(np.round(_base(t) + noise), -32768, 32767
                   ).astype(np.int16)


def card_audio(S: int, T: int, seed: int, salt: str, device):
    """(S, T) int16 on ``device``, made there by a seeded generator in a few
    large calls."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, salt))
    t = torch.arange(T, dtype=torch.float64, device=device) / RATE
    base = (9000 * torch.sin(2 * torch.pi * (200 + 3000 * t) * t)
            + 4000 * torch.sin(2 * torch.pi * 900 * t))
    noise = torch.randint(-1500, 1500, (S, T), generator=gen, device=device)
    return torch.clamp(torch.round(base + noise), -32768, 32767
                       ).to(torch.int16)
