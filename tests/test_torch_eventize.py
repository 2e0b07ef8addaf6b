"""The port's eventizer (``ops/eventize.py``) vs the JAX package's, on the
CPU, where it takes its plain version (the card tests of its CUDA kernel are
in ``tests/test_torch_kernels.py``).

Tolerances: none.  The dense arrays (fired, attack, duration, final_active,
final_started) must be JAX's bit for bit: both fold the rising-edge sums in
the same order with IEEE float32 adds and divisions, and NaN compares false
on both sides.  Event lists, in both velocity modes, and the compact tables
must be equal.  Below 6 frames the JAX eventizer fails to trace (its shifted
copies do not broadcast), so there the plain version is held against a
scalar transcription of the reference's state machine, written here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu.ops import eventize as jax_eventize
from audio_to_midi_tpu_torch.ops import eventize as pt_eventize
from tests.test_torch_serving import smooth_probs

torch.set_num_threads(2)

DENSE = ("fired", "attack", "duration", "final_active", "final_started")


def seeded_probs(kind: str, frames: int, seed: int, keys: int = 90) -> np.ndarray:
    if kind == "walk":  # random-walk probabilities that cross every threshold
        return smooth_probs(seed, frames, keys)
    return np.random.default_rng(seed).random((frames, keys)).astype(np.float32)


def edge_case(name: str) -> np.ndarray:
    p = np.zeros((40, 8), np.float32)
    if name == "zeros":
        return p
    if name == "ones":
        return np.ones((40, 8), np.float32)
    if name == "held to the end":
        p[3:, 0] = 0.9                       # attack at 3, never released
        p[10:, 1] = np.linspace(0.45, 1.0, 30)
        p[25:31, 1] = [0.3, 0.95, 0.97, 0.99, 0.98, 0.96]  # re-activation, then held
        p[5:20, 2] = 0.6                     # attack, then release
        p[39, 3] = 0.51                      # attack on the last frame
        return p
    if name == "at the thresholds":
        p[:, :3] = np.float32(0.5)           # p > 0.5 is false at 0.5
        p[8:, 1] = np.float32(0.1)           # p < 0.1 is false at 0.1
        p[:4, 2] = 0.9
        p[4:, 2] = np.float32(0.4)
        p[:, 3] = np.tile(np.float32([0.9, 0.1, 0.4, 0.5, 0.09]), 8)
        return p
    if name == "nan rows":
        p = smooth_probs(5, 40, 8)
        p[7] = np.nan                        # a whole frame
        p[20:23, 2] = np.nan                 # a key's run
        p[30, 5] = np.nan
        return p
    raise KeyError(name)


EDGE_CASES = ("zeros", "ones", "held to the end", "at the thresholds", "nan rows")


def _assert_dense_equal(out, ref):
    for name, o, r in zip(DENSE, out, ref):
        o, r = o.numpy(), np.asarray(r)
        assert o.dtype == r.dtype and o.shape == r.shape, name
        np.testing.assert_array_equal(o, r, err_msg=name)


@pytest.mark.parametrize("kind", ["walk", "uniform"])
@pytest.mark.parametrize("frames", [6, 7, 250, 3000])
def test_dense_matches_jax_bit_for_bit(kind, frames):
    p = seeded_probs(kind, frames, seed=frames)
    _assert_dense_equal(pt_eventize.extract_events_dense(p),
                        jax_eventize.extract_events_dense(jnp.asarray(p)))


@pytest.mark.parametrize("name", EDGE_CASES)
def test_dense_edge_cases_match_jax_bit_for_bit(name):
    p = edge_case(name)
    _assert_dense_equal(pt_eventize.extract_events_dense(p),
                        jax_eventize.extract_events_dense(jnp.asarray(p)))


def _scalar_reference(p: np.ndarray) -> tuple[np.ndarray, ...]:
    """The reference's state machine key by key, frame by frame, in float32
    scalars (common.rs:47-144, with the dense outputs of the JAX scan)."""
    n, keys = p.shape
    f32 = np.float32
    fired = np.zeros((n, keys), bool)
    attack = np.zeros((n, keys), np.int32)
    duration = np.zeros((n, keys), np.int32)
    final_active = np.zeros(keys, bool)
    final_started = np.zeros(keys, np.int32)
    at = lambda f, k: p[f, k] if 0 <= f < n else f32(0)
    for k in range(keys):
        active, started = False, 0
        for f in range(n):
            prev, nxt = f32(0), f32(0)
            for j in range(6):
                prev = f32(prev + at(f - 6 + j, k))
                nxt = f32(nxt + at(f + j, k))
            rising = f32(nxt / f32(6)) - f32(prev / f32(6)) > f32(0.1)
            defer = f + 1 < n and p[f, k] < p[f + 1, k]
            pf = p[f, k]
            deactivate = active and pf < f32(0.1)
            reactivate = (active and not deactivate and not defer and pf > f32(0.4)
                          and f - started > 5 and rising)
            attack_new = not active and pf > f32(0.5)
            fired[f, k] = deactivate or reactivate
            attack[f, k] = started
            duration[f, k] = max(f - 1 - started if reactivate else f - started, 1)
            active = (active and not deactivate) or attack_new
            started = f if reactivate or attack_new else started
        final_active[k], final_started[k] = active, started
    return fired, attack, duration, final_active, final_started


@pytest.mark.parametrize("frames", [1, 2, 3, 4, 5, 6, 7])
def test_dense_of_few_frames_matches_the_scalar_reference(frames):
    for kind in ("walk", "uniform"):
        p = seeded_probs(kind, frames, seed=frames, keys=12)
        p[:, 0] = 0.9  # a key attacked on frame 0 and held to the end
        _assert_dense_equal(pt_eventize.extract_events_dense(p), _scalar_reference(p))


def test_scalar_reference_is_the_jax_scan():
    """The scalar transcription above agrees with JAX where JAX traces."""
    p = seeded_probs("walk", 60, seed=3, keys=6)
    for out, ref in zip(_scalar_reference(p), jax_eventize.extract_events_dense(jnp.asarray(p))):
        np.testing.assert_array_equal(out, np.asarray(ref))


def _card_decomposition(p: np.ndarray) -> tuple[np.ndarray, ...]:
    """The CUDA kernel's two steps (csrc/eventize.cu) in numpy: each cell
    reduced to three flags -- low (p < 0.1), can_react (not low, not
    deferred, p > 0.4, rising) and high (p > 0.5) -- then the walk over the
    frames on the flags alone, the time test in integers."""
    rising, defer = pt_eventize._rising_and_defer(p)
    low = p < np.float32(0.1)
    can_react = ~low & ~defer & (p > np.float32(0.4)) & rising
    high = p > np.float32(0.5)
    n, keys = p.shape
    fired = np.zeros((n, keys), bool)
    attack = np.zeros((n, keys), np.int32)
    duration = np.zeros((n, keys), np.int32)
    active, started = np.zeros(keys, bool), np.zeros(keys, np.int32)
    for f in range(n):
        deactivate = active & low[f]
        reactivate = active & can_react[f] & (f - started > 5)
        attack_new = ~active & high[f]
        fired[f], attack[f] = deactivate | reactivate, started
        duration[f] = np.maximum(np.where(reactivate, f - 1 - started, f - started), 1)
        active = (active & ~deactivate) | attack_new
        started = np.where(reactivate | attack_new, f, started).astype(np.int32)
    return fired, attack, duration, active, started


@pytest.mark.parametrize("case", ["walk 3000", "uniform 250", "walk 5", *EDGE_CASES])
def test_the_card_decomposition_gives_the_dense_arrays(case):
    """What the kernel folds into its flags and walks on gives the plain
    version's arrays, and JAX's where JAX traces."""
    if case in EDGE_CASES:
        p = edge_case(case)
    else:
        kind, frames = case.split()
        p = seeded_probs(kind, int(frames), seed=21)
    out = [torch.from_numpy(a) for a in _card_decomposition(p)]
    _assert_dense_equal(out, pt_eventize.extract_events_dense_plain(p))
    if p.shape[0] >= 6:
        _assert_dense_equal(out, jax_eventize.extract_events_dense(jnp.asarray(p)))


# NaN rows only at velocity 7: the real-velocity extension rounds a peak
# probability, which a NaN note has not (both packages raise there).
@pytest.mark.parametrize("case,real_velocity", [
    ("walk 700", False), ("walk 700", True), ("uniform 250", False), ("uniform 250", True),
    ("held to the end", False), ("held to the end", True), ("nan rows", False),
])
def test_event_lists_match_jax(case, real_velocity):
    if case in EDGE_CASES:
        p = edge_case(case)
    else:
        kind, frames = case.split()
        p = seeded_probs(kind, int(frames), seed=11)
    ref = jax_eventize.extract_events(jnp.asarray(p), real_velocity=real_velocity)
    assert len(ref) > 0
    assert pt_eventize.extract_events(p, real_velocity=real_velocity) == ref
    assert pt_eventize.extract_events(torch.from_numpy(p), real_velocity=real_velocity) == ref


@pytest.mark.parametrize("room", [10, 0, -400])
def test_compact_table_matches_jax(room):
    """Rows in emission order, zeros past the count; a table too small for
    every event keeps its first rows and the count of all of them."""
    p = seeded_probs("uniform", 500, seed=4)
    max_events = int(pt_eventize.extract_events_dense_plain(p)[0].sum()) + room
    table, count, active, started = pt_eventize.extract_events_compact(p, max_events)
    ref = jax_eventize.extract_events_compact(jnp.asarray(p), max_events)
    np.testing.assert_array_equal(table.numpy(), np.asarray(ref[0]))
    assert count == int(ref[1]) == max_events - room
    np.testing.assert_array_equal(active.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(started.numpy(), np.asarray(ref[3]))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = pt_eventize.eventize.launches
    p = seeded_probs("walk", 100, seed=1)
    for out, ref in zip(pt_eventize.eventize(torch.from_numpy(p)),
                        pt_eventize.extract_events_dense_plain(p)):
        np.testing.assert_array_equal(out.numpy(), ref)
    assert pt_eventize.eventize.launches == before
    assert pt_eventize.KERNELS == (pt_eventize.eventize,)


def test_eventize_refuses_other_devices_and_shapes():
    with pytest.raises(ValueError):
        pt_eventize.eventize(torch.zeros(10, 90, device="meta"))
    with pytest.raises(ValueError):
        pt_eventize.eventize(torch.zeros(10))
