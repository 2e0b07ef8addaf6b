"""Plotting helpers (reference audio_to_midi_dataset.py:356-512).

Counterpart of ``audio_to_midi_tpu/utils/visualize.py``: the same figures,
from numpy arrays or tensors (a tensor is brought to the host as float32).
``matplotlib`` is imported only when a figure is drawn, so the port imports
without it; drawing without it raises ``ImportError`` naming it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import MIDI_EVENT_VOCAB_SIZE


def _plt():
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("the figures need matplotlib, which is not installed") from e
    return plt


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def plot_output_probs(sample_name: str, duration_per_frame: float, events):
    """Probability heatmap over time (reference :416-433)."""
    plt = _plt()
    events = _np(events)
    fig, ax1 = plt.subplots()
    x = np.linspace(0.0, duration_per_frame * events.shape[0], events.shape[0])
    y = np.arange(MIDI_EVENT_VOCAB_SIZE)
    c = ax1.pcolor(x, y, events.T)
    ax1.set(title=f"Probs {sample_name}", xlabel="Time [s]", ylabel="MIDI Event")
    fig.colorbar(c)
    ax1_twin = ax1.twiny()
    ax1_twin.set_xlim(0, events.shape[0])
    ax1_twin.set_xlabel("Frame count")
    return fig


def plot_time_domain_audio(sample_rate: int, samples):
    plt = _plt()
    samples = _np(samples)
    t = np.linspace(0, samples.size / sample_rate, samples.size)
    fig, ax = plt.subplots()
    ax.plot(t, samples)
    ax.set(xlabel="time (s)", ylabel="amplitude", title="Audio signal")
    ax.grid()
    return fig


def plot_frequency_domain_audio(sample_name: str, samples, events=None):
    """Waveform (+ optional label heatmap) panel (reference :372-414)."""
    plt = _plt()
    samples = _np(samples)
    if events is None:
        fig, ax1 = plt.subplots()
    else:
        fig, (ax1, ax3) = plt.subplots(nrows=2, ncols=1)
    left = samples[0][::5]
    right = samples[1][::5]
    ax1.plot(left, label="Left")
    ax1.plot(right, label="Right")
    ax1.set(ylabel="Amplitude", xlabel="Time [s]", title=f"Audio signal\n{sample_name}")
    ax1.legend(loc="upper right")
    ax1.set_ylim(-5, 5)
    ax1.set_xlim(0, left.shape[0])
    if events is not None:
        events = _np(events)
        x = np.arange(events.shape[0])
        y = np.arange(MIDI_EVENT_VOCAB_SIZE)
        c = ax3.pcolor(x, y, events.T)
        ax3.set(xlabel="Frame count", ylabel="MIDI Event")
        fig.colorbar(c, orientation="horizontal")
    plt.tight_layout()
    return fig


def plot_prob_dist(quantity: str, dist):
    """Probability distribution line plot (reference infer.py:160-170)."""
    plt = _plt()
    dist = _np(dist)
    fig, ax1 = plt.subplots()
    ax1.plot(np.arange(dist.shape[0]), dist)
    ax1.set(
        xlabel=quantity,
        ylabel="Probability",
        title=f"Probability distribution for {quantity}",
    )
    return fig


def plot_embedding(sample_name: str, embeddings):
    plt = _plt()
    embeddings = _np(embeddings)
    fig, ax1 = plt.subplots()
    x = np.arange(embeddings.shape[0]) + 1
    y = np.arange(embeddings.shape[1])
    ax1.pcolor(x, y, embeddings.T)
    ax1.set(xlabel="Frame", ylabel="Embedding", title=f"Audio frame embeddings\n{sample_name}")
    return fig


def visualize_sample(sample_name: str, samples, events):
    return plot_frequency_domain_audio(sample_name, samples, events=events)
