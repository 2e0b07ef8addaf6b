"""Eventization: frame probabilities -> MIDI events.

Counterpart of ``audio_to_midi_tpu/ops/eventize.py`` (reference rust
common.rs:47-144), with velocity fixed at 7.  An independent state machine
per key runs over the frames:
  * attack when p > 0.5 while inactive;
  * release when p < 0.1 while active (duration = frame - start, min 1);
  * re-activation while active: more than 5 frames since the attack, a
    rising edge (mean of the next 6 frames minus mean of the previous 6 > 0.1,
    both sums divided by 6 even where truncated at the end), p > 0.4, and not
    p[f] < p[f+1] (deferred to the local peak).  Emits the old note with
    duration frame-1-start (min 1) and restarts at the current frame;
  * notes still active at the end close with duration N - start.

This runs on the host, in numpy, on the CPU copy of the stitched
(frames, 90) float32 probabilities: vectorized over keys, a loop over
frames.  An on-device eventizer is later work.
"""

from __future__ import annotations

import numpy as np

ACTIVATION_THRESHOLD = np.float32(0.5)
DEACTIVATION_THRESHOLD = np.float32(0.1)
REACTIVATION_THRESHOLD = np.float32(0.4)
REACTIVATION_GAP = np.float32(0.1)
REACTIVATION_MIN_FRAMES = 5
EDGE_SAMPLES = 6
FIXED_VELOCITY = 7


def _rising_and_defer(p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-(frame, key) rising-edge and defer flags, summed in the same
    left-to-right float32 order as the JAX package."""
    num_frames, num_keys = p.shape

    def shifted(offset: int) -> np.ndarray:
        # Row f holds p[f + offset], zero outside the sequence.
        out = np.zeros_like(p)
        if offset >= 0:
            out[: num_frames - offset] = p[offset:]
        else:
            out[-offset:] = p[: num_frames + offset]
        return out

    prev_sum = np.zeros_like(p)
    next_sum = np.zeros_like(p)
    for i in range(EDGE_SAMPLES):
        prev_sum = prev_sum + shifted(i - EDGE_SAMPLES)
        next_sum = next_sum + shifted(i)
    edge = np.float32(EDGE_SAMPLES)
    rising = (next_sum / edge - prev_sum / edge) > REACTIVATION_GAP
    defer = np.zeros((num_frames, num_keys), bool)
    defer[:-1] = p[:-1] < p[1:]
    return rising, defer


def extract_events(probs: np.ndarray) -> list[tuple[int, int, int, int]]:
    """(frames, keys) probabilities -> sorted (attack, key, duration, 7) list."""
    p = np.asarray(probs, np.float32)
    num_frames, num_keys = p.shape
    rising, defer = _rising_and_defer(p)
    active = np.zeros(num_keys, bool)
    started = np.zeros(num_keys, np.int64)
    events: list[tuple[int, int, int, int]] = []
    for f in range(num_frames):
        pf = p[f]
        deactivate = active & (pf < DEACTIVATION_THRESHOLD)
        reactivate = (
            active & ~deactivate & ~defer[f] & (pf > REACTIVATION_THRESHOLD)
            & (f - started > REACTIVATION_MIN_FRAMES) & rising[f]
        )
        attack_new = ~active & (pf > ACTIVATION_THRESHOLD)
        for k in np.nonzero(deactivate | reactivate)[0]:
            end = f - 1 if reactivate[k] else f
            events.append((int(started[k]), int(k), max(end - int(started[k]), 1),
                           FIXED_VELOCITY))
        active = (active & ~deactivate) | attack_new
        started = np.where(reactivate | attack_new, f, started)
    for k in np.nonzero(active)[0]:
        s = int(started[k])
        events.append((s, int(k), max(num_frames - s, 1), FIXED_VELOCITY))
    events.sort()
    return events
