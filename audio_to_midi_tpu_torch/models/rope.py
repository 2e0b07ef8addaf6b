"""Rotary positional embeddings, halves layout.

Counterpart of ``audio_to_midi_tpu/models/rope.py``.  The q/k up-projection
weights are stored with each head's output columns already permuted to
[0, 2, 4, ..., 1, 3, 5, ...] (the JAX package does that at init and at
checkpoint import), so the rotation acts on contiguous halves.  The port
reads those weights as they are and never permutes them again.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RopeFreqs(NamedTuple):
    cos: torch.Tensor  # (max_pos, dim // 2) float32
    sin: torch.Tensor  # (max_pos, dim // 2) float32


def rope_permutation(head_dim: int) -> np.ndarray:
    """The per-head column permutation of the halves layout: the rotation
    pairs (2j, 2j + 1) become (j, j + head_dim / 2)."""
    half = head_dim // 2
    perm = np.empty((head_dim,), np.int64)
    perm[:half] = np.arange(half) * 2
    perm[half:] = np.arange(half) * 2 + 1
    return perm


def precompute_frequencies(
    dim: int, max_pos: int, theta: float = 10_000.0, device: torch.device | str = "cpu"
) -> RopeFreqs:
    exponent = torch.arange(0, dim, 2, dtype=torch.float32)[: dim // 2] / dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exponent)
    t = torch.arange(0, max_pos, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    return RopeFreqs(cos=torch.cos(freqs).to(device), sin=torch.sin(freqs).to(device))


def rope_with(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Halves-layout rotation with explicit per-row tables.

    x: (..., S, H, hd); cos/sin: (S, hd // 2) float32.  Computed in float32
    and cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = cos[:, None, :]
    s = sin[:, None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


def apply_rope_halves(x: torch.Tensor, rope: RopeFreqs) -> torch.Tensor:
    """RoPE over the sequence axis (-3) of x: (..., S, H, hd), positions 0..S-1."""
    seq_len = x.shape[-3]
    return rope_with(x, rope.cos[:seq_len], rope.sin[:seq_len])
