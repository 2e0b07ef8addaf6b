"""Plain eventizer (reference rust common.rs 47-144): frame probabilities ->
sorted (attack, key, duration, velocity) notes.

Each key runs its own state machine over the frames:

* attack when p > 0.5 while inactive;
* release when p < 0.1 while active, duration frame - start (at least 1);
* re-attack while active when all of these hold: more than 5 frames since
  the attack, p > 0.4, a rising edge, and p[f] >= p[f + 1] (the attack waits
  for the local peak).  The edge is rising when the mean of the next 6
  frames minus the mean of the previous 6 is above 0.1.  Each sum runs left
  to right in float32, is divided by 6 even where the sequence cuts it
  short, and counts 0 outside the sequence.  The old note ends with
  duration frame - 1 - start (at least 1), and a new one starts here;
* a note still active after the last frame ends with duration N - start.

Velocity is the constant 7.
"""

from __future__ import annotations

import numpy as np

VELOCITY = 7
EDGE = 6


def _edges(p: np.ndarray) -> np.ndarray:
    frames = p.shape[0]
    padded = np.concatenate([np.zeros((EDGE, p.shape[1]), np.float32), p,
                             np.zeros((EDGE, p.shape[1]), np.float32)])
    before = np.zeros_like(p)
    after = np.zeros_like(p)
    for i in range(EDGE):
        before = before + padded[i: i + frames]                    # p[f - 6 + i]
        after = after + padded[EDGE + i: EDGE + i + frames]        # p[f + i]
    six = np.float32(EDGE)
    return (after / six - before / six) > np.float32(0.1)


def events(probs) -> list[tuple[int, int, int, int]]:
    """(N, K) probabilities -> the sorted note list."""
    p = np.asarray(probs, np.float32)
    frames, keys = p.shape
    rising = _edges(p)
    peak_ahead = np.zeros_like(rising)
    peak_ahead[:-1] = p[:-1] < p[1:]
    active = np.zeros(keys, bool)
    start = np.zeros(keys, np.int64)
    notes = []
    for f in range(frames):
        pf = p[f]
        release = active & (pf < np.float32(0.1))
        again = (active & ~release & ~peak_ahead[f] & (pf > np.float32(0.4))
                 & (f - start > 5) & rising[f])
        for k in np.flatnonzero(release):
            notes.append((int(start[k]), int(k), max(f - int(start[k]), 1), VELOCITY))
        for k in np.flatnonzero(again):
            notes.append((int(start[k]), int(k), max(f - 1 - int(start[k]), 1), VELOCITY))
        attack = ~active & (pf > np.float32(0.5))
        start[again | attack] = f
        active = (active & ~release) | attack
    for k in np.flatnonzero(active):
        notes.append((int(start[k]), int(k), max(frames - int(start[k]), 1), VELOCITY))
    return sorted(notes)
