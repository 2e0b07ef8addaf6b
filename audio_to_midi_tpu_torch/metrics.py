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
back.  ``generate_visualization`` draws the two-panel figure of the
inferred and expected rasters (matplotlib, imported then).
``configure_tensorboard`` mirrors reference metrics.py:5-10 with
``torch.utils.tensorboard``.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any

import numpy as np
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
    their device, numpy arrays run on the CPU.  ``generate_visualization``:
    the inferred / expected figure in ``.visualization``."""
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
        visualization=_visualize(_host(probs), _host(expected)) if generate_visualization
        else None,
    )


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _visualize(output_probs: np.ndarray, expected: np.ndarray):
    """Two-panel inferred/expected heatmap (reference infer.py:131-149)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the metrics' figure needs matplotlib, which is not installed") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    norm = plt.Normalize(vmin=0.0, vmax=1.0)
    fig, (ax1, ax2) = plt.subplots(nrows=2, ncols=1)
    n = output_probs.shape[0]
    x = np.linspace(0.0, n, n)
    y = np.arange(output_probs.shape[1])
    ax1.pcolor(x, y, output_probs.T, cmap="viridis", norm=norm)
    ax1.set(ylabel="Inferred events")
    ax2.pcolor(x[: expected.shape[0]], y, expected[:n].T, cmap="viridis", norm=norm)
    ax2.set(xlabel="Time [frame]", ylabel="Expected events")
    return fig


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
