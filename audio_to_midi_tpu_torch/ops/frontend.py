"""Audio frontend on tensors: loudness normalization and window slicing.

Counterpart of ``make_windows`` and ``normalize_loudness`` in
``audio_to_midi_tpu/ops/frontend.py``.  They run on whatever device the
samples lie on.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def normalize_loudness(samples: torch.Tensor) -> torch.Tensor:
    """Unit-variance normalization over both channels with a silence guard.

    samples: (2, N).  If max |s| <= 0.05 the audio is left as it is;
    otherwise it is scaled by 1/sqrt(mean(s^2)) over both channels jointly.
    """
    x = samples.float()
    peak = x.abs().max()
    variance = x.square().mean()
    adjustment = torch.where(peak <= 0.05, torch.ones_like(variance), torch.rsqrt(variance))
    return (x * adjustment).to(samples.dtype)


def make_windows(samples: torch.Tensor, window_size: int, overlap_samples: int) -> torch.Tensor:
    """(2, N) -> (W, 2, window_size) overlapping windows, the last zero-padded.

    Windows start every ``window_size - overlap_samples`` samples and W is
    ``max(1, ceil((N - overlap) / step))``.
    """
    step = window_size - overlap_samples
    n = samples.shape[1]
    n_windows = max(1, math.ceil((n - overlap_samples) / step))
    pad_to = (n_windows - 1) * step + window_size
    padded = F.pad(samples, (0, max(0, pad_to - n)))
    return padded.unfold(1, window_size, step).transpose(0, 1).contiguous()
