"""Plain crossfade stitch of overlapping windows (reference rust common.rs
13-45), window after window.

Window w starts at output frame int(w * (F - ov)), accumulated in floating
point, with ov = overlap / duration_per_frame.  From the second window on,
its rows r <= ceil(ov) blend linearly with what is there:
(1 - r / ov) * old + (r / ov) * new.  Every other row is overwritten.  The
output has W * F - int(ov) * (W - 1) frames.
"""

from __future__ import annotations

import math

import torch


def stitch(probs: torch.Tensor, overlap_s: float, window_s: float) -> torch.Tensor:
    """probs (W, F, E) -> (frames, E) float32."""
    count, frames, keys = probs.shape
    ov = float(overlap_s) / (float(window_s) / frames)
    total = int(count * frames - int(ov) * (count - 1))
    out = torch.zeros((total + frames, keys), dtype=torch.float32, device=probs.device)
    rows = torch.arange(frames, device=probs.device, dtype=torch.float32)[:, None]
    blend = rows / ov if ov > 0 else None
    base = 0.0
    for w in range(count):
        start = int(base)
        new = probs[w].float()
        if w > 0 and ov > 0:
            old = out[start: start + frames]
            mixed = (1.0 - blend) * old + blend * new
            new = torch.where(rows <= math.ceil(ov), mixed, new)
        out[start: start + frames] = new
        base += frames - ov
    return out[:total]
