"""Event list -> dense frame labels.

Counterpart of ``audio_to_midi_tpu/ops/rasterize.py``.  Reference semantics
(python.rs:423-447 ``convert_to_frame_events``): a zeroed (num_frames, 90)
buffer; events in sorted order, each
  1. zeroes the frame just before its (shifted) attack when that attack is in
     (0, num_frames) -- the fast-re-activation separator;
  2. writes ``decay(t) = max(exp(-0.05 t), 0.6)`` over
     [max(0, start), min(end, num_frames, backing_frames)).

:func:`rasterize_events_np` is the sequential numpy version (host label
prep).  :func:`rasterize_dense` takes the dense eventizer output
(``ops/eventize.extract_events_dense``) on its device: per key the spans are
chronological and do not overlap, so a frame is zero if some event attacks
at the next frame, and otherwise takes the decay of the span that covers it
-- the one of the last attack at or before the frame.  JAX carries that
attack through a ``lax.scan`` over frames; here it is one ``torch.cummax``
over the frame axis, and no kernel is needed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import MIDI_EVENT_VOCAB_SIZE


def _decay_np(t: np.ndarray) -> np.ndarray:
    return np.maximum(np.exp(-0.05 * t), 0.6)


def rasterize_events_np(
    events,
    num_frames: int,
    start_frame: int = 0,
    backing_frames: int | None = None,
    num_keys: int = MIDI_EVENT_VOCAB_SIZE,
) -> np.ndarray:
    """Sequential port of reference python.rs:423-447.  float32 output."""
    if backing_frames is None:
        backing_frames = num_frames
    frames = np.zeros((num_frames, num_keys), np.float32)
    for attack, key, duration, _velocity in events:
        if not 0 <= key < num_keys:  # a malformed CSV key must not index
            continue
        fs = int(attack) - start_frame
        fe = fs + int(duration)
        if 0 < fs < num_frames:
            frames[fs - 1, key] = 0.0
        lo = max(fs, 0)
        hi = min(fe, num_frames, backing_frames)
        if hi > lo:
            t = np.arange(lo, hi, dtype=np.float32) - fs
            frames[lo:hi, key] = _decay_np(t)
    return frames


def rasterize_dense(
    fired: torch.Tensor,
    attack: torch.Tensor,
    duration: torch.Tensor,
    final_active: torch.Tensor,
    final_attack: torch.Tensor,
) -> torch.Tensor:
    """(N, K) float32 on the inputs' device, equal to
    ``rasterize_events_np(extract_events(probs), N)``; the arguments as
    ``extract_events_dense`` returns them."""
    num_frames, num_keys = fired.shape
    device = fired.device
    keys = torch.arange(num_keys, device=device)
    attack = attack.long()
    # Scatter each event to its attack row: attacked[a, k] and its end
    # ends[a, k] = a + duration.  Row num_frames is the drop row.
    rows = torch.where(fired, attack, num_frames)
    cols = keys.expand(num_frames, num_keys)
    attacked = torch.zeros((num_frames + 1, num_keys), dtype=torch.bool, device=device)
    attacked[rows, cols] = True
    ends = torch.zeros((num_frames + 1, num_keys), dtype=torch.long, device=device)
    ends[rows, cols] = attack + duration.long()
    # The notes still active at the end (closed with duration N - start, min 1).
    final_attack = final_attack.long()
    tail_rows = torch.where(final_active, final_attack, num_frames)
    tail_end = torch.clamp(num_frames - final_attack, min=1) + final_attack
    attacked[tail_rows, keys] = True
    ends[tail_rows, keys] = torch.maximum(ends[tail_rows, keys],
                                          torch.where(final_active, tail_end, 0))
    attacked, ends = attacked[:num_frames], ends[:num_frames]

    # The covering span of frame t: the last attack at or before t.
    frame = torch.arange(num_frames, device=device)[:, None]
    last = torch.cummax(torch.where(attacked, frame, -1), dim=0).values
    end = torch.gather(ends, 0, last.clamp(min=0))
    t = (frame - last).to(torch.float32)
    values = torch.where((last >= 0) & (frame < end),
                         torch.maximum(torch.exp(-0.05 * t), torch.tensor(0.6, device=device)),
                         0.0)
    # The separator: frame t is zero when an attack lands on t + 1.
    zero = torch.zeros_like(attacked)
    zero[:-1] = attacked[1:]
    return torch.where(zero, 0.0, values)


def to_frame_events(event_lists, frame_count: int) -> list[np.ndarray]:
    """Reference ``modelutil.to_frame_events`` (python.rs:980-1005)."""
    return [rasterize_events_np(events, frame_count, 0, frame_count) for events in event_lists]
