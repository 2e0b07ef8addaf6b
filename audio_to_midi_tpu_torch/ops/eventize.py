"""Eventization: frame probabilities -> MIDI events.

Counterpart of ``audio_to_midi_tpu/ops/eventize.py`` (reference rust
common.rs:47-144).  An independent state machine per key runs over the
frames:
  * attack when p > 0.5 while inactive;
  * release when p < 0.1 while active (duration = frame - start, min 1);
  * re-activation while active: more than 5 frames since the attack, a
    rising edge (mean of the next 6 frames minus mean of the previous 6 > 0.1,
    both sums divided by 6 even where truncated at the end), p > 0.4, and not
    p[f] < p[f+1] (deferred to the local peak).  Emits the old note with
    duration frame-1-start (min 1) and restarts at the current frame;
  * notes still active at the end close with duration N - start;
  * velocity 7, the reference's constant; ``real_velocity=True`` derives it
    from the note's peak probability instead (the JAX package's extension).

Where it runs follows the probabilities: :func:`eventize` takes a CUDA
tensor to the kernel of ``csrc/eventize.cu`` (the scan over frames of JAX's
``extract_events_dense``, which XLA compiles; not a Pallas kernel), and a
CPU tensor or a numpy array to :func:`extract_events_dense_plain`, a numpy
loop over frames vectorized over keys.  Both give the JAX package's dense
arrays bit for bit.  On the card the fired cells are gathered into an event
table there (:func:`extract_events_compact`, :func:`extract_events`): only
that table, its count and the final state go to the host, never the dense
raster.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import span
from . import cuda_build

ACTIVATION_THRESHOLD = np.float32(0.5)
DEACTIVATION_THRESHOLD = np.float32(0.1)
REACTIVATION_THRESHOLD = np.float32(0.4)
REACTIVATION_GAP = np.float32(0.1)
REACTIVATION_MIN_FRAMES = np.float32(5.0)
EDGE_SAMPLES = 6
FIXED_VELOCITY = 7
MAX_FRAMES = 1 << 24  # the card's walk compares frames as integers, exact as float32 below

Event = tuple[int, int, int, int]


def _rising_and_defer(p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-(frame, key) rising-edge and defer flags, summed in the same
    left-to-right float32 order as the JAX package."""
    num_frames, num_keys = p.shape

    def shifted(offset: int) -> np.ndarray:
        # Row f holds p[f + offset], zero outside the sequence.
        out = np.zeros_like(p)
        n = max(num_frames - abs(offset), 0)
        if offset >= 0:
            out[:n] = p[offset : offset + n]
        else:
            out[num_frames - n :] = p[:n]
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


def extract_events_dense_plain(probs) -> tuple[np.ndarray, ...]:
    """Plain version of :func:`eventize`: (N, K) probabilities -> fired (N,
    K) bool, attack and duration (N, K) int32 (every cell: the attack frame
    before the step and the duration an emission there would have),
    final_active (K,) bool, final_started (K,) int32, as numpy arrays."""
    p = np.asarray(probs, np.float32)
    num_frames, num_keys = p.shape
    rising, defer = _rising_and_defer(p)
    fired = np.zeros((num_frames, num_keys), bool)
    attack = np.zeros((num_frames, num_keys), np.int32)
    duration = np.zeros((num_frames, num_keys), np.int32)
    active = np.zeros(num_keys, bool)
    started = np.zeros(num_keys, np.int32)
    for f in range(num_frames):
        pf = p[f]
        deactivate = active & (pf < DEACTIVATION_THRESHOLD)
        time_ok = (np.float32(f) - started.astype(np.float32)) > REACTIVATION_MIN_FRAMES
        reactivate = (active & ~deactivate & ~defer[f] & (pf > REACTIVATION_THRESHOLD)
                      & time_ok & rising[f])
        attack_new = ~active & (pf > ACTIVATION_THRESHOLD)
        fired[f] = deactivate | reactivate
        attack[f] = started
        duration[f] = np.maximum(np.where(reactivate, f - 1 - started, f - started), 1)
        active = (active & ~deactivate) | attack_new
        started = np.where(reactivate | attack_new, np.int32(f), started).astype(np.int32)
    return fired, attack, duration, active, started


def eventize(probs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The eventizer's state machine on (N, K) probabilities: (fired,
    attack, duration, final_active, final_started) on the probabilities'
    device (see :func:`extract_events_dense_plain` for their meaning).

    A CPU tensor takes the plain version.  A CUDA tensor launches the kernel
    (``csrc/eventize.cu``: the per-frame flags over the whole card, then the
    walk over frames) or raises: ``ValueError`` for a tensor that is not (N,
    K) with 1 <= N <= 2^24 (float(frame) is exact below: 93 hours at 50
    frames per second) and K >= 1.  Counts its launches in ``.launches``."""
    if probs.dim() != 2:
        raise ValueError(f"probabilities must be (frames, keys), got {tuple(probs.shape)}")
    if probs.device.type == "cpu":
        return tuple(torch.from_numpy(a)
                     for a in extract_events_dense_plain(probs.detach().float().numpy()))
    if probs.device.type != "cuda":
        raise ValueError(f"eventize runs on CPU or CUDA, not {probs.device}")
    n, k = probs.shape
    if not (1 <= n <= MAX_FRAMES and k >= 1):
        raise ValueError(f"eventize takes 1 .. 2^24 frames and at least one key, got {(n, k)}")
    p = probs.float().contiguous()
    fired = torch.empty((n, k), dtype=torch.bool, device=p.device)
    attack = torch.empty((n, k), dtype=torch.int32, device=p.device)
    duration = torch.empty((n, k), dtype=torch.int32, device=p.device)
    final_active = torch.empty(k, dtype=torch.bool, device=p.device)
    final_started = torch.empty(k, dtype=torch.int32, device=p.device)
    lib = cuda_build.library()
    flags = torch.empty(lib.a2m_eventize_workspace(n, k), dtype=torch.uint8, device=p.device)
    with torch.cuda.device(p.device):
        code = lib.a2m_eventize(
            p.data_ptr(), fired.data_ptr(), attack.data_ptr(), duration.data_ptr(),
            final_active.data_ptr(), final_started.data_ptr(), flags.data_ptr(), n, k,
            torch.cuda.current_stream(p.device).cuda_stream)
    cuda_build.check(code, "eventize")
    eventize.launches += 1
    return fired, attack, duration, final_active, final_started


eventize.launches = 0
KERNELS = (eventize,)


def extract_events_dense(probs) -> tuple[torch.Tensor, ...]:
    """JAX's ``extract_events_dense``: :func:`eventize` on a tensor, or on a
    numpy array (as a CPU tensor)."""
    if not isinstance(probs, torch.Tensor):
        probs = torch.from_numpy(np.asarray(probs, np.float32))
    return eventize(probs)


def _event_rows(fired: torch.Tensor, attack: torch.Tensor,
                duration: torch.Tensor) -> torch.Tensor:
    """The (count, 3) int32 rows (attack, key, duration) of the fired cells,
    in the cells' order (emission frame, then key), on their device."""
    cells = torch.nonzero(fired.reshape(-1)).squeeze(1)
    keys = (cells % fired.shape[1]).to(torch.int32)
    return torch.stack([attack.reshape(-1)[cells], keys, duration.reshape(-1)[cells]], dim=1)


def extract_events_compact(probs, max_events: int):
    """JAX's ``extract_events_compact``: (table, count, final_active,
    final_started), the table (max_events, 3) int32 rows (attack, key,
    duration) of the emitted events in emission order on the probabilities'
    device, zeros past ``count`` (an int: all the events, also past
    ``max_events``, whose rows are then dropped)."""
    fired, attack, duration, final_active, final_started = extract_events_dense(probs)
    rows = _event_rows(fired, attack, duration)
    count = rows.shape[0]
    table = torch.zeros((max_events, 3), dtype=torch.int32, device=rows.device)
    table[: min(count, max_events)] = rows[:max_events]
    return table, count, final_active, final_started


def extract_events(probs, real_velocity: bool = False) -> list[Event]:
    """(frames, keys) probabilities -> sorted (attack, key, duration,
    velocity) list.

    A CUDA tensor is eventized on the card; the event rows and the final
    state come back to the host in one copy.  Velocity is 7 (the
    reference's constant); ``real_velocity=True`` takes round(10 * the
    note's peak probability), clipped to [1, 10], from a host copy of the
    probabilities, as the JAX package does.

    Span ``eventize`` (frames, notes) over ``eventize.kernel`` (the dense
    pass and the rows), ``eventize.fetch`` (the one copy to the host) and
    ``eventize.host`` (the note table, its sort and the tuples)."""
    with span("eventize") as s:
        with span("eventize.kernel"):
            fired, attack, duration, final_active, final_started = extract_events_dense(probs)
            num_frames, num_keys = fired.shape
            rows = _event_rows(fired, attack, duration)
            packed = torch.cat([rows.reshape(-1), final_active.to(torch.int32), final_started])
        with span("eventize.fetch"):
            host = packed.cpu().numpy()
        with span("eventize.host"):
            table = host[: rows.numel()].reshape(-1, 3)
            active = host[rows.numel() : rows.numel() + num_keys].astype(bool)
            started = host[rows.numel() + num_keys :]
            final = np.nonzero(active)[0]
            notes = np.concatenate([table, np.stack([started[final], final,
                                                    np.maximum(num_frames - started[final], 1)], 1)])
            attack, key, length = notes.T.astype(np.int64)
            velocity = np.full(len(notes), FIXED_VELOCITY, np.int64)
            if real_velocity:
                p = (probs.float().cpu().numpy() if isinstance(probs, torch.Tensor)
                     else np.asarray(probs, np.float32))
                for i, (a, k, d) in enumerate(zip(attack, key, length)):
                    peak = float(p[a : a + d, k].max()) if d > 0 else 0.0
                    velocity[i] = int(np.clip(round(peak * 10), 1, 10))
            events = np.stack([attack, key, length, velocity], 1)
            # Tuples sort by attack, then key, duration, velocity: lexsort's last key first.
            events = events[np.lexsort((velocity, length, key, attack))]
            events = list(map(tuple, events.tolist()))
        s.add("frames", num_frames)
        s.add("notes", len(events))
        return events
