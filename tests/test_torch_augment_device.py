"""The port's device augmentations (audio_to_midi_tpu_torch/data/augment_device.py):
the batched waves against the sequential plain version on the same draws, bit
for bit; probability 0; label smoothing; and each transform's distribution
against the JAX package's (threefry draws there, a torch generator here: the
distributions, not the streams, carry over)."""

import jax
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu.data.augment_device import (
    transform_for_training_device as jax_transform)
from audio_to_midi_tpu_torch.config import TransformSettings
from audio_to_midi_tpu_torch.data import augment_device as ad

torch.set_num_threads(2)

OFF = dict(pan_probability=0.0, channel_switch_probability=0.0, cut_probability=0.0,
           rotate_probability=0.0, random_erasing_probability=0.0, mixup_probability=0.0,
           gain_probability=0.0, noise_probability=0.0, label_smoothing_alpha=0.0)
FIELD = {"pan": "pan_probability", "channel_switch": "channel_switch_probability",
         "cut_mix": "cut_probability", "rotate": "rotate_probability",
         "random_erasing": "random_erasing_probability", "mixup": "mixup_probability",
         "gain": "gain_probability", "noise": "noise_probability", "eq": "eq_probability",
         "dynamics_warp": "dynamics_warp_probability", "am_jitter": "am_jitter_probability"}


def _batch(b, n, f, seed):
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((b, 2, n)).astype(np.float32)
    labels = rng.random((b, f, 90)).astype(np.float32)
    return torch.from_numpy(audio), torch.from_numpy(labels)


def test_waves_keep_the_sequential_reads():
    assert ad.waves(np.array([0, 0, 1, 0]), None).tolist() == [0, 1, 0, 2]
    # app 1 writes the item app 0 read (same wave: reads come first); app 2
    # reads what app 0 wrote (a later wave)
    assert ad.waves(np.array([0, 1, 2]), np.array([1, 2, 0])).tolist() == [0, 0, 1]
    assert ad.waves(np.array([0, 1]), np.array([1, 1])).tolist() == [0, 0]
    assert ad.waves(np.array([1, 0]), np.array([0, 1])).tolist() == [0, 1]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("timbre", [False, True])
def test_waves_equal_the_sequential_version_bit_for_bit(seed, timbre):
    """Two items and eight draws of each transform: every item is hit
    several times by every transform, and cut-mix and mixup chain through
    each other's writes."""
    settings = TransformSettings(**{f: 4.0 for f in FIELD.values() if timbre
                                    or f not in ("eq_probability", "dynamics_warp_probability",
                                                 "am_jitter_probability")})
    audio, labels = _batch(2, 1024, 32, seed)
    audio[1, 0] = 0.0  # a single-channel item: pan leaves it
    draws = ad.draw(settings, 2, 1024, 32, torch.Generator().manual_seed(seed), "cpu")
    assert len(draws.stages) == (11 if timbre else 8)
    assert all(st.n == 8 and len(st.bounds) > 2 for st in draws.stages)
    a1, l1, a2, l2 = audio.clone(), labels.clone(), audio.clone(), labels.clone()
    ad.augment_(a1, l1, draws)
    ad.augment_sequential(a2, l2, draws)
    assert not torch.equal(a1, audio)
    assert torch.equal(a1, a2) and torch.equal(l1, l2)


@pytest.mark.parametrize("seed", [3, 4])
def test_waves_equal_the_sequential_version_at_the_default_probabilities(seed):
    audio, labels = _batch(64, 512, 16, seed)
    draws = ad.draw(TransformSettings(), 64, 512, 16, torch.Generator().manual_seed(seed), "cpu")
    assert sum(st.n for st in draws.stages) == 51 + 32 + 25 + 57 + 19 + 38 + 51 + 51
    # a wave per round: far fewer than the applications
    assert sum(len(st.bounds) - 1 for st in draws.stages) < 50
    a1, l1, a2, l2 = audio.clone(), labels.clone(), audio.clone(), labels.clone()
    ad.augment_(a1, l1, draws)
    ad.augment_sequential(a2, l2, draws)
    assert torch.equal(a1, a2) and torch.equal(l1, l2)


def test_probability_zero_is_the_identity():
    audio, labels = _batch(4, 256, 10, 1)
    a, l = ad.transform_for_training_device(audio, labels, TransformSettings(**OFF),
                                            torch.Generator().manual_seed(0))
    assert torch.equal(a, audio) and torch.equal(l, labels)


def test_label_smoothing_is_exact():
    audio, labels = _batch(4, 256, 10, 2)
    labels[0, 0, :3] = torch.tensor([0.0, 1.0, 0.5])
    _, l = ad.transform_for_training_device(
        audio, labels, TransformSettings(**{**OFF, "label_smoothing_alpha": 0.005}),
        torch.Generator().manual_seed(0))
    assert np.array_equal(l.numpy(), np.clip(labels.numpy(), np.float32(0.005),
                                             np.float32(1 - 0.005)))


def test_the_same_generator_state_gives_the_same_batch():
    audio, labels = _batch(8, 512, 10, 3)
    one = ad.transform_for_training_device(audio, labels, TransformSettings(),
                                           torch.Generator().manual_seed(5))
    two = ad.transform_for_training_device(audio, labels, TransformSettings(),
                                           torch.Generator().manual_seed(5))
    other = ad.transform_for_training_device(audio, labels, TransformSettings(),
                                             torch.Generator().manual_seed(6))
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    assert not torch.equal(one[0], other[0])
    assert one[0].shape == audio.shape and torch.isfinite(one[0]).all()


# --- distributions against JAX ----------------------------------------------

B, N, F = 64, 512, 16
ROUNDS = 8


def _input(name: str) -> tuple[np.ndarray, np.ndarray]:
    ids = np.arange(B, dtype=np.float32)
    labels = np.broadcast_to(ids[:, None, None] / B, (B, F, 90)).copy()
    if name in ("pan", "gain", "random_erasing", "am_jitter"):
        audio = np.ones((B, 2, N), np.float32)
    elif name == "channel_switch":
        audio = np.stack([np.ones((B, N)), 2 * np.ones((B, N))], 1).astype(np.float32)
    elif name in ("cut_mix", "mixup"):
        audio = np.broadcast_to(ids[:, None, None], (B, 2, N)).copy()
    elif name == "rotate":
        audio = np.broadcast_to(np.arange(N, dtype=np.float32), (B, 2, N)).copy()
    elif name == "noise":
        audio = np.zeros((B, 2, N), np.float32)
    elif name == "eq":
        audio = np.random.default_rng(0).standard_normal((B, 2, N)).astype(np.float32)
    else:  # dynamics_warp: a decaying tone
        t = np.arange(N) / 16_000.0
        note = (np.exp(-40 * t) * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
        audio = np.broadcast_to(note, (B, 2, N)).copy()
    return audio, labels


def _summary(name: str, audio: np.ndarray, labels: np.ndarray, a: np.ndarray,
             l: np.ndarray) -> np.ndarray:
    """Per-item statistics of one transform's effect, (B, m)."""
    ids = np.arange(B)[:, None, None]
    if name == "pan":
        return a[:, :, 0]
    if name == "channel_switch":
        return (a[:, 0, :1] == 2).astype(np.float64)
    if name == "cut_mix":
        return np.stack([(a[:, 0] != ids[:, 0]).mean(-1),
                         (l[:, :, 0] != labels[:, :, 0]).mean(-1)], 1)
    if name == "rotate":
        return np.stack([((N - a[:, 0, 0]) % N) / N, (a[:, 0, 0] != 0)], 1)
    if name == "random_erasing":
        return (a[:, 0] == 0).mean(-1, keepdims=True)
    if name == "mixup":
        return np.stack([np.abs(a[:, 0, 0] - ids[:, 0, 0]), (l[:, 0, 0] != labels[:, 0, 0])], 1)
    if name == "gain":
        return a[:, 0, :1]
    if name == "noise":
        return a.std(-1)
    if name == "eq":
        return np.sqrt((a ** 2).mean(-1) / (audio ** 2).mean(-1))
    if name == "dynamics_warp":
        rms = np.sqrt((a ** 2).mean(-1))
        return np.abs(a).max(-1) / rms
    return a.mean(-1)  # am_jitter


@pytest.mark.parametrize("name", list(FIELD))
def test_distribution_matches_jax(name):
    prob = 0.9 if name in ("eq", "dynamics_warp", "am_jitter") else getattr(
        TransformSettings(), FIELD[name])
    pt_settings = TransformSettings(**{**OFF, FIELD[name]: prob})
    jax_settings = jax_config.TransformSettings(**{**OFF, FIELD[name]: prob})
    audio, labels = _input(name)
    ours, ref = [], []
    for r in range(ROUNDS):
        a, l = ad.transform_for_training_device(torch.from_numpy(audio), torch.from_numpy(labels),
                                                pt_settings, torch.Generator().manual_seed(r))
        ours.append(_summary(name, audio, labels, a.numpy(), l.numpy()))
        a, l = jax_transform(audio, labels, jax_settings, jax.random.PRNGKey(r))
        ref.append(_summary(name, audio, labels, np.asarray(a), np.asarray(l)))
    ours, ref = np.concatenate(ours).astype(np.float64), np.concatenate(ref).astype(np.float64)
    n = len(ours)
    # Each column's mean within 5 standard errors (items of one batch are
    # drawn with replacement, so the spread is a little wider than
    # independent draws'), and the spreads within 30 %.
    se = np.sqrt(ours.var(0) / n + ref.var(0) / n)
    assert np.all(np.abs(ours.mean(0) - ref.mean(0)) <= 5 * se + 1e-6), (
        ours.mean(0), ref.mean(0), se)
    assert np.all(np.abs(ours.std(0) - ref.std(0)) <= 0.3 * ref.std(0) + 1e-6), (
        ours.std(0), ref.std(0))
