"""Drop-in surface of the reference's Rust plugin module ``modelutil``
(python.rs:1007-1020), through the port.

Counterpart of ``audio_to_midi_tpu/modelutil.py``: the same function names,
arguments and return conventions (numpy arrays, lists and tuples), so that a
caller of the reference can ``import audio_to_midi_tpu_torch.modelutil as
modelutil`` unchanged.  As there, each function takes the C++ native plane
(``native.py``) when it is built, and otherwise the port's own host code:
``data/loader``, ``ops/stitch``, ``ops/eventize`` and ``ops/rasterize`` on
the CPU.  The on-device forms are ``ops.stitch.stitch_probs_parallel`` and
``ops.eventize.extract_events`` on a CUDA tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import native
from .config import TransformSettings
from .data import loader as _loader
from .ops import eventize as _eventize
from .ops import rasterize as _rasterize
from .ops import stitch as _stitch


@dataclass
class DatasetTransfromSettings:  # (sic) -- reference spelling, python.rs:840
    pan_probability: float
    channel_switch_probability: float
    cut_probability: float
    rotate_probability: float
    random_erasing_probability: float
    mixup_probability: float
    gain_probability: float
    noise_probability: float
    label_smoothing_alpha: float

    def _to_settings(self) -> TransformSettings:
        return TransformSettings(
            pan_probability=self.pan_probability,
            channel_switch_probability=self.channel_switch_probability,
            cut_probability=self.cut_probability,
            rotate_probability=self.rotate_probability,
            random_erasing_probability=self.random_erasing_probability,
            mixup_probability=self.mixup_probability,
            gain_probability=self.gain_probability,
            noise_probability=self.noise_probability,
            label_smoothing_alpha=self.label_smoothing_alpha,
        )


def load_full_audio(file: str, sample_rate: int) -> np.ndarray:
    """python.rs:373-394: (2, N) float32, normalized, cache bypassed."""
    return _loader.load_full_audio(file, sample_rate)


def load_events_and_audio(
    dataset_dir: str,
    sample_names: list[str],
    sample_rate: int,
    model_duration: float,
    num_model_outputs: int,
    skip_cache: bool = False,
):
    """python.rs:949-960: (audio windows, label rasters, window names)."""
    return _loader.load_events_and_audio(
        dataset_dir, list(sample_names), sample_rate, model_duration, num_model_outputs,
        skip_cache,
    )


def load_events_and_audio_with_transformations(
    dataset_dir: str,
    sample_names: list[str],
    sample_rate: int,
    model_duration: float,
    num_model_outputs: int,
    settings: DatasetTransfromSettings | TransformSettings,
    skip_cache: bool = False,
):
    """python.rs:934-947."""
    if isinstance(settings, DatasetTransfromSettings):
        settings = settings._to_settings()
    return _loader.load_events_and_audio_with_transformations(
        dataset_dir, list(sample_names), sample_rate, model_duration, num_model_outputs,
        settings, skip_cache,
    )


def stitch_probs(probs: np.ndarray, overlap: float, duration_per_frame: float) -> np.ndarray:
    """common.rs:13-45 (the native plane when built, else ``ops/stitch``)."""
    probs = np.asarray(probs, np.float32)
    if native.available():
        return native.stitch_probs(probs, overlap, duration_per_frame)
    return _stitch.stitch_probs(torch.from_numpy(probs), overlap, duration_per_frame).numpy()


def extract_events(probs: np.ndarray) -> list[tuple[int, int, int, int]]:
    """common.rs:47-144."""
    probs = np.asarray(probs, np.float32)
    if native.available():
        return native.extract_events(probs)
    return _eventize.extract_events(probs)


def to_frame_events(event_lists, frame_count: int) -> list[np.ndarray]:
    """python.rs:980-1005."""
    if native.available():
        return [
            native.rasterize_events(list(events), frame_count, 0, frame_count)
            for events in event_lists
        ]
    return _rasterize.to_frame_events(event_lists, frame_count)
