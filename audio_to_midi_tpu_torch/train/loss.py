"""Training loss.

Counterpart of ``audio_to_midi_tpu/train/loss.py``.  Reference semantics:
the per-sample loss is sigmoid binary cross-entropy SUMMED over (frames x 90
keys) -- the sum, not the mean, defines the loss scale everything else is
tuned around (AdamW eps=1e-3, the 10k loss-scaling threshold) -- multiplied
by the f16 grad scale, then MEANED over the batch.  Logits are cast to f32
before the loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..models import model as model_lib
from ..models.rope import RopeFreqs


def sigmoid_bce_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed BCE per sample, in the numerically stable form.
    logits/labels: (..., F, K) -> (...)."""
    loss = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    return loss.sum(dim=(-2, -1))


def batch_loss(
    model: model_lib.Model,
    cfg: ModelConfig,
    audio: torch.Tensor,
    labels: torch.Tensor,
    rope: RopeFreqs,
    scale: torch.Tensor | float,
    compute_dtype: torch.dtype,
    *,
    enable_dropout: bool = True,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Scaled mean-over-batch of summed BCE (the reference's compute_loss).

    The forward runs in ``compute_dtype``: the audio is cast to it and every
    parameter is cast at its use, so the parameters themselves (and their
    ``.grad``) stay in their own dtype.  The loss is f32.  ``generator`` (on
    the audio's device) drives the dropout of this one forward.
    """
    logits, _probs = model_lib.forward(
        model, cfg, audio.to(compute_dtype), rope,
        enable_dropout=enable_dropout, generator=generator)
    per_sample = sigmoid_bce_sum(logits.float(), labels.float())
    return (per_sample * scale).mean()
