"""Plain serving frontend: resample, loudness normalization, windows.

* Resampling by the rational rate up/down (divided by their gcd) with a
  polyphase FIR of ``taps_per_phase * up`` taps: a Kaiser-windowed sinc
  (beta 8), cutoff 0.5 / max(up, down) of the upsampled rate, unit DC gain,
  times ``up``.  Output m is the correlation of the reversed filter with the
  zero-stuffed input (x[i] at i * up), padded in front by half the taps,
  read at m * down.  Here it is taken output by output, summing the taps
  that fall on a stuffed sample.
* Loudness: scaled by 1 / sqrt(mean square) over both channels, unless the
  peak is at most 0.05.
* Windows: ``window`` samples every ``window - overlap``, the last
  zero-padded, at least one.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _filter(up: int, down: int, taps_per_phase: int) -> np.ndarray:
    num_taps = taps_per_phase * up
    cutoff = 0.5 / max(up, down)
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2
    h = np.sinc(2 * cutoff * n) * 2 * cutoff * np.kaiser(num_taps, 8.0)
    return (h / h.sum()).astype(np.float32) * np.float32(up)


def resample(x: torch.Tensor, src_rate: int, dst_rate: int, taps_per_phase: int = 16,
             block: int = 1 << 21) -> torch.Tensor:
    """x (C, N) float32 -> (C, ceil(N * dst / src)) float32 on x's device."""
    g = math.gcd(dst_rate, src_rate)
    up, down = dst_rate // g, src_rate // g
    if up == down:
        return x.float()
    h_rev = torch.as_tensor(_filter(up, down, taps_per_phase)[::-1].copy(), device=x.device)
    pad = (taps_per_phase * up) // 2
    n = x.shape[1]
    out_len = -(-n * up // down)
    taps = torch.arange(taps_per_phase, device=x.device)
    xf = x.float()
    out = torch.empty((x.shape[0], out_len), dtype=torch.float32, device=x.device)
    for lo in range(0, out_len, block):
        m = torch.arange(lo, min(lo + block, out_len), device=x.device, dtype=torch.int64)
        first = -((pad - m * down) // up)          # ceil((m * down - pad) / up)
        idx = first[:, None] + taps[None, :]  # the input samples under the filter
        coef = h_rev[idx * up + pad - (m * down)[:, None]]
        inside = (idx >= 0) & (idx < n)
        samples = xf[:, idx.clamp(0, n - 1)] * inside
        out[:, lo: lo + m.shape[0]] = (samples * coef).sum(dim=-1)
    return out


def normalize_loudness(x: torch.Tensor) -> torch.Tensor:
    if float(x.abs().max()) <= 0.05:
        return x
    return x / torch.sqrt(x.square().mean())


def windows(x: torch.Tensor, window: int, overlap: int) -> torch.Tensor:
    """(C, N) -> (W, C, window)."""
    step = window - overlap
    n = x.shape[1]
    count = max(1, math.ceil((n - overlap) / step))
    padded = torch.zeros((x.shape[0], (count - 1) * step + window), dtype=x.dtype, device=x.device)
    padded[:, :n] = x
    return torch.stack([padded[:, i * step: i * step + window] for i in range(count)])


def prepare(samples: torch.Tensor, src_rate: int, dst_rate: int, window: int,
            overlap: int) -> torch.Tensor:
    """Raw (C, N) audio at ``src_rate`` -> (W, C, window) float32 model windows."""
    return windows(normalize_loudness(resample(samples, src_rate, dst_rate)), window, overlap)
