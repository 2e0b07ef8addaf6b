"""Evaluation metrics on the model's device.

Counterpart of ``audio_to_midi_tpu/metrics.py``.  ``detailed_event_loss``
reimplements reference infer.py:94-158: eventize the predicted
probabilities, rasterize the events again, and compare with the expected
frame labels:
  * full_diff ("eventized diff") = sum |rasterized(eventized(probs)) - expected|
  * phantom_notes_diff = count of predicted-only cells
  * missed_notes_diff  = sum of expected values at missed cells
  * notes_hit, hit_rate = hit / (hit + phantom + missed)

The eventizer is ``ops/eventize.extract_events_dense`` (the CUDA kernel for
a tensor on the card, the numpy state machine on the CPU) and the raster
``ops/rasterize.rasterize_dense``, so on the card only five numbers come
back.  ``configure_tensorboard`` mirrors reference metrics.py:5-10 with
``torch.utils.tensorboard``.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any

import torch

from .ops.eventize import extract_events_dense
from .ops.rasterize import rasterize_dense


@dataclass
class DetailedEventLoss:
    full_diff: float
    phantom_notes_diff: float
    missed_notes_diff: float
    notes_hit: int
    hit_rate: float
    visualization: Any | None = None


def detailed_event_loss_device(output_probs: torch.Tensor,
                               expected: torch.Tensor) -> dict[str, torch.Tensor]:
    """(N, 90) predicted probabilities and (>= N, 90) expected labels, on
    one device -> the metrics as 0-d tensors there, and the raster."""
    predicted = rasterize_dense(*extract_events_dense(output_probs))
    expected = expected[: predicted.shape[0]].to(device=predicted.device, dtype=torch.float32)

    full_diff = torch.sum(torch.abs(predicted - expected))
    played_predicted = predicted > 0
    played_expected = expected > 0
    phantom = torch.sum(played_predicted & ~played_expected)
    missed = torch.sum(torch.where(played_expected & ~played_predicted, expected, 0.0))
    hit = torch.sum(played_predicted & played_expected)
    denom = hit + phantom + missed
    hit_rate = torch.where(denom > 0, hit / denom, 1.0)
    return {
        "full_diff": full_diff,
        "phantom_notes_diff": phantom.to(torch.float32),
        "missed_notes_diff": missed,
        "notes_hit": hit,
        "hit_rate": hit_rate,
        "predicted_raster": predicted,
    }


def detailed_event_loss(output_probs, expected,
                        generate_visualization: bool = False) -> DetailedEventLoss:
    """Host-facing wrapper (reference infer.py:94-158): tensors stay on
    their device, numpy arrays run on the CPU.  The figure waits for the
    port's ``utils/visualize.py``."""
    if generate_visualization:
        raise NotImplementedError("the metrics' figure waits for the port's utils/visualize.py")
    probs = torch.as_tensor(output_probs)
    expected = torch.as_tensor(expected)
    out = detailed_event_loss_device(probs, expected)
    host = torch.stack([out[key].to(torch.float64) for key in
                        ("full_diff", "phantom_notes_diff", "missed_notes_diff", "notes_hit",
                         "hit_rate")]).cpu().numpy()
    return DetailedEventLoss(
        full_diff=float(host[0]),
        phantom_notes_diff=float(host[1]),
        missed_notes_diff=float(host[2]),
        notes_hit=int(host[3]),
        hit_rate=float(host[4]),
    )


def configure_tensorboard(run_dir: str | None = None):
    """A ``torch.utils.tensorboard`` writer in runs/<ISO timestamp>
    (reference metrics.py:5-10).  Needs the ``tensorboard`` package."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise ImportError(
            "the tensorboard package is not installed: install it, or train with "
            "--no-tensorboard") from e
    if run_dir is None:
        run_dir = f"runs/{datetime.datetime.now().isoformat()}"
    return SummaryWriter(run_dir)
