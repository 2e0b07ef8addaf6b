"""Crossfade stitching of overlapping inference windows, on tensors.

Counterpart of ``audio_to_midi_tpu/ops/stitch.py`` (reference rust
common.rs:13-45): windows are laid out every ``frames_per_window -
overlapping_frames`` output frames (float accumulation, truncated per
window); within the first ``ceil(overlapping_frames)`` frames of every
window after the first, the value is cross-faded linearly with what the
previous window wrote (``blend = frame / overlapping_frames``); all other
frames are overwritten by the latest window.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def stitch_plan(
    num_windows: int, frames_per_window: int, overlap: float, duration_per_frame: float
) -> tuple[np.ndarray, int, float]:
    """Static geometry: per-window output base index, total frames, overlap."""
    overlapping_frames = float(overlap) / float(duration_per_frame)
    output_frames = int(
        num_windows * frames_per_window - int(overlapping_frames) * (num_windows - 1)
    )
    bases = np.zeros((num_windows,), np.int64)
    base = 0.0
    for w in range(num_windows):
        bases[w] = int(base)
        base += frames_per_window - overlapping_frames
    return bases, output_frames, overlapping_frames


def _blend_weights(fpw: int, ov: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    r = torch.arange(fpw, device=device)
    blend = (r.float() / ov)[:, None]
    in_blend = (r <= math.ceil(ov))[:, None]
    return blend, in_blend


def stitch_probs(
    all_probs: torch.Tensor, overlap: float, duration_per_frame: float
) -> torch.Tensor:
    """Sequential stitcher: (num_windows, frames_per_window, E) ->
    (output_frames, E) float32, each window written over the previous."""
    num_windows, fpw, e = all_probs.shape
    bases, output_frames, ov = stitch_plan(num_windows, fpw, overlap, duration_per_frame)
    probs = all_probs.float()
    out = torch.zeros((output_frames + fpw, e), dtype=torch.float32, device=probs.device)
    if ov > 0:
        blend, in_blend = _blend_weights(fpw, ov, probs.device)
    for w in range(num_windows):
        base = int(bases[w])
        cur = out[base : base + fpw]
        if w > 0 and ov > 0:
            new = torch.where(in_blend, (1.0 - blend) * cur + blend * probs[w], probs[w])
        else:
            new = probs[w]
        out[base : base + fpw] = new
    return out[:output_frames]


def stitch_probs_parallel(
    all_probs: torch.Tensor, overlap: float, duration_per_frame: float
) -> torch.Tensor:
    """Batch stitcher, identical output to :func:`stitch_probs`.

    The sequential loop is pairwise: window w's blend region only reads
    window w-1's final rows, and every output row is finally owned by the
    last window that writes it (rows [b_w, b_{w+1}) belong to w).  So all
    blends compute at once from a shifted gather of the previous window, and
    the owned rows concatenate.  Where windows advance by no more than the
    blend width the precondition fails and the sequential stitcher runs.
    """
    num_windows, fpw, e = all_probs.shape
    bases, output_frames, ov = stitch_plan(num_windows, fpw, overlap, duration_per_frame)
    probs = all_probs.float()
    if num_windows == 1:
        return probs[0][:output_frames]
    d = bases[1:] - bases[:-1]
    if ov > 0 and int(np.min(d)) <= math.ceil(ov):
        return stitch_probs(all_probs, overlap, duration_per_frame)

    if ov > 0:
        blend, in_blend = _blend_weights(fpw, ov, probs.device)
        r = torch.arange(fpw, device=probs.device)
        # Window w (>0) blends row r with window w-1's row d_w + r; past
        # w-1's last row the sequential loop reads zeros.
        idx = torch.as_tensor(d, device=probs.device)[:, None] + r[None, :]
        prev = torch.gather(
            probs[:-1], 1, idx.clamp(max=fpw - 1)[:, :, None].expand(-1, -1, e)
        )
        cur = torch.where((idx >= fpw)[:, :, None], torch.zeros_like(prev), prev)
        tail = torch.where(in_blend[None], (1.0 - blend) * cur + blend * probs[1:], probs[1:])
        final = torch.cat([probs[:1], tail], dim=0)
    else:
        final = probs

    own = np.concatenate([d, [fpw]])  # rows [0, own_w) of window w are final
    owned = torch.cat([final[w, : int(own[w])] for w in range(num_windows)], dim=0)
    out = torch.zeros((output_frames, e), dtype=torch.float32, device=probs.device)
    n = min(output_frames, owned.shape[0])
    out[:n] = owned[:n]
    return out
