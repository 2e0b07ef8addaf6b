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

from ..utils.profiling import span


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
    last window that writes it (rows [b_w, b_{w+1}) belong to w).  So the
    whole sequence is one chunk of :func:`stitch_chunk`, all blends at once,
    and the rows past the last owned one are zero.  Where windows advance by
    no more than the blend width the precondition fails and the sequential
    stitcher runs.  Span ``ops.stitch`` (frames out).
    """
    with span("ops.stitch") as s:
        num_windows, fpw, e = all_probs.shape
        try:
            d, own, output_frames, ov = stitch_chunk_plan(
                num_windows, fpw, overlap, duration_per_frame)
        except ValueError:
            out = stitch_probs(all_probs, overlap, duration_per_frame)
        else:
            owned = stitch_chunk(all_probs.new_zeros((fpw, e)), all_probs, d=d, own=own, ov=ov,
                                 first=True)
            out = torch.zeros((output_frames, e), dtype=torch.float32, device=all_probs.device)
            n = min(output_frames, owned.shape[0])
            out[:n] = owned[:n]
        s.add("frames", out.shape[0])
        return out


# --- streaming (chunked) stitching, bit for bit the batch stitcher's rows ---


def stitch_chunk_plan(
    num_windows: int, frames_per_window: int, overlap: float, duration_per_frame: float
) -> tuple[np.ndarray, np.ndarray, int, float]:
    """Per-window blend-read offsets ``d`` (d[0] unused) and owned-row counts
    ``own`` for chunked stitching, with the output's frames and the overlap
    in frames.

    Derived from the same float-accumulated global bases as
    :func:`stitch_plan`, so chunk boundaries never perturb the geometry
    (with non-integral overlap frames the bases are non-uniform and must be
    computed globally).  Raises ``ValueError`` where the pairwise-blend
    precondition fails (window stride <= blend width): only the sequential
    stitcher reproduces the chained blends there."""
    bases, output_frames, ov = stitch_plan(
        num_windows, frames_per_window, overlap, duration_per_frame
    )
    d = np.concatenate([[0], bases[1:] - bases[:-1]])
    next_base = np.concatenate([bases[1:], [bases[-1] + frames_per_window]])
    own = next_base - bases
    if ov > 0 and num_windows > 1 and int(np.min(d[1:])) <= math.ceil(ov):
        raise ValueError(
            "chunked stitching needs the pairwise-blend precondition "
            "(window stride > blend width); use the batch stitcher for "
            f"overlap {overlap} at {duration_per_frame}s/frame"
        )
    return d, own, output_frames, ov


def stitch_chunk(
    prev_window: torch.Tensor, chunk_probs: torch.Tensor, *, d: list[int], own: list[int],
    ov: float, first: bool,
) -> torch.Tensor:
    """The stitched rows owned by this chunk's windows: the same rows of
    :func:`stitch_probs_parallel` over the whole sequence, bit for bit, on
    the same device.

    prev_window: (fpw, E) probabilities of the window just before the chunk
    (ignored when ``first``); chunk_probs: (Wc, fpw, E); ``d`` / ``own``:
    this chunk's entries of :func:`stitch_chunk_plan`.  Every output row
    depends on at most two adjacent windows, so one context window per chunk
    gives the batch rows, and a window's owned rows are the prefix [0,
    own_w) of its blended rows."""
    probs = chunk_probs.float()
    wc, fpw, e = probs.shape
    if ov > 0:
        prevs = torch.cat([prev_window.float()[None], probs[:-1]], dim=0)
        blend, in_blend = _blend_weights(fpw, ov, probs.device)
        r = torch.arange(fpw, device=probs.device)
        idx = torch.as_tensor(np.asarray(d, np.int64), device=probs.device)[:, None] + r[None, :]
        prev_rows = torch.gather(
            prevs, 1, idx.clamp(max=fpw - 1)[:, :, None].expand(-1, -1, e)
        )
        cur = torch.where((idx >= fpw)[:, :, None], torch.zeros_like(prev_rows), prev_rows)
        final = torch.where(in_blend[None], (1.0 - blend) * cur + blend * probs, probs)
        if first:  # window 0 of the whole sequence is never blended
            final = torch.cat([probs[:1], final[1:]], dim=0)
    else:
        final = probs
    return torch.cat([final[i, : int(own[i])] for i in range(wc)], dim=0)
