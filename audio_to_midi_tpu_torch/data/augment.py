"""Train-time augmentation suite (host-side, numpy).

Faithful port of the reference's Rust augmentations (python.rs:566-932), each
applied to ``p * batch_size`` randomly chosen items, in the reference's fixed
order: pan, channel_switch, cut_mix, rotate, random_erasing, mixup, gain,
noise, label_smoothing.

The reference passes ``channel_switch_probability`` to the pan transform
(python.rs:923) — a bug.  ``TransformSettings.parity_pan_uses_channel_switch_probability``
reproduces it when set.

A batch is (audio (B, 2, N) float32, labels (B, F, K) float32), mutated in
place.  The JAX package's ``data/augment.py``: under one
``np.random.Generator`` seed it gives the same bits.  The device version is
:mod:`audio_to_midi_tpu_torch.data.augment_device`.
"""

from __future__ import annotations

import numpy as np

from ..config import TransformSettings


def _num_applications(prob: float, size: int) -> int:
    return int(prob * size)


def pan(audio: np.ndarray, rng: np.random.Generator, prob: float) -> None:
    size = audio.shape[0]
    eps = 0.01
    for _ in range(_num_applications(prob, size)):
        idx = rng.integers(0, size)
        left, right = audio[idx, 0], audio[idx, 1]
        if np.all(np.abs(left) < eps) or np.all(np.abs(right) < eps):
            continue  # single-channel content: leave to gain/channel-switch
        pan_factor = rng.uniform(0.0, 1.0)
        audio[idx, 0] = left * min(2.0 * (1.0 - pan_factor), 1.0)
        audio[idx, 1] = right * min(2.0 * pan_factor, 1.0)


def channel_switch(audio: np.ndarray, rng: np.random.Generator, prob: float) -> None:
    size = audio.shape[0]
    for _ in range(_num_applications(prob, size)):
        idx = rng.integers(0, size)
        audio[idx] = audio[idx, ::-1]


def cut_mix(
    audio: np.ndarray, labels: np.ndarray, rng: np.random.Generator, prob: float
) -> None:
    size = audio.shape[0]
    min_cut = 0.01
    for _ in range(_num_applications(prob, size)):
        a = rng.integers(0, size)
        b = rng.integers(0, size)
        cut_start = rng.uniform(0.0, 1.0 - min_cut)
        cut_length = rng.uniform(min_cut, 1.0 - cut_start)

        n = audio.shape[2]
        lo, hi = int(cut_start * n), int((cut_start + cut_length) * n)
        audio[a, :, lo:hi] = audio[b, :, lo:hi]

        f = labels.shape[1]
        flo, fhi = int(cut_start * f), int((cut_start + cut_length) * f)
        labels[a, flo:fhi] = labels[b, flo:fhi]


def rotate(
    audio: np.ndarray, labels: np.ndarray, rng: np.random.Generator, prob: float
) -> None:
    size = audio.shape[0]
    for _ in range(_num_applications(prob, size)):
        idx = rng.integers(0, size)
        roll = rng.uniform(0.0, 1.0)
        audio[idx] = np.roll(audio[idx], int(roll * audio.shape[2]), axis=1)
        labels[idx] = np.roll(labels[idx], int(roll * labels.shape[1]), axis=0)


def random_erasing(audio: np.ndarray, rng: np.random.Generator, prob: float) -> None:
    size = audio.shape[0]
    min_erase, max_erase = 0.01, 0.10
    for _ in range(_num_applications(prob, size)):
        idx = rng.integers(0, size)
        start = rng.uniform(0.0, 1.0 - min_erase)
        length = rng.uniform(min_erase, min(max_erase, 1.0 - start))
        n = audio.shape[2]
        audio[idx, :, int(start * n) : int((start + length) * n)] = 0.0


def mixup(
    audio: np.ndarray, labels: np.ndarray, rng: np.random.Generator, prob: float
) -> None:
    size = audio.shape[0]
    for _ in range(_num_applications(prob, size)):
        a = rng.integers(0, size)
        b = rng.integers(0, size)
        lam = rng.beta(2.0, 2.0)
        audio[a] = lam * audio[a] + (1.0 - lam) * audio[b]
        labels[a] = np.maximum(labels[a], labels[b])  # element-wise max, not lerp


def gain(audio: np.ndarray, rng: np.random.Generator, prob: float) -> None:
    size = audio.shape[0]
    for _ in range(_num_applications(prob, size)):
        idx = rng.integers(0, size)
        g = float(np.clip(rng.normal(1.0, 0.25), 0.5, 1.5))
        audio[idx] *= g


def noise(audio: np.ndarray, rng: np.random.Generator, prob: float) -> None:
    size = audio.shape[0]
    for _ in range(_num_applications(prob, size)):
        idx = rng.integers(0, size)
        sigma = rng.uniform(0.0, 0.25)
        audio[idx] += rng.normal(0.0, sigma, audio[idx].shape).astype(audio.dtype)


def label_smoothing(labels: np.ndarray, alpha: float) -> None:
    if alpha > 0:
        np.clip(labels, alpha, 1.0 - alpha, out=labels)


def transform_for_training(
    audio: np.ndarray,
    labels: np.ndarray,
    settings: TransformSettings,
    rng: np.random.Generator,
) -> None:
    """Apply the full suite in the reference order (python.rs:922-932)."""
    pan_prob = (
        settings.channel_switch_probability
        if settings.parity_pan_uses_channel_switch_probability
        else settings.pan_probability
    )
    pan(audio, rng, pan_prob)
    channel_switch(audio, rng, settings.channel_switch_probability)
    cut_mix(audio, labels, rng, settings.cut_probability)
    rotate(audio, labels, rng, settings.rotate_probability)
    random_erasing(audio, rng, settings.random_erasing_probability)
    mixup(audio, labels, rng, settings.mixup_probability)
    gain(audio, rng, settings.gain_probability)
    noise(audio, rng, settings.noise_probability)
    label_smoothing(labels, settings.label_smoothing_alpha)
