"""Optimizer: AdamW with CNN layer-wise learning-rate decay.

Counterpart of ``audio_to_midi_tpu/train/optim.py``, whose optax chain runs
in an order ``torch.optim.AdamW`` cannot express:

  1. Adam moments (b1=.9, b2=.999) with bias correction and eps=1e-3 added
     OUTSIDE the root (eps intentionally large -- the reference's value);
  2. ``+ weight_decay * param``;
  3. ``* -lr(count)``: linear warm-up from 0, then cosine decay, read at the
     count BEFORE the increment -- so with a warm-up the first update is 0;
  4. ``* factor`` per parameter: CNN parameters get
     ``layer_lr_decay ** (max_depth - depth)``, where the stem or downsample
     of stage i has depth ``sum(depths[:i])`` and block j of that stage that
     plus j + 1; everything outside the CNN 1.0;
  5. global-norm clip 1.0 on the UPDATES, last.

The port's parameters are unstacked (``nn.ModuleList``), so a block's factor
is one scalar per parameter.  The chain runs as a few multi-tensor
(``torch._foreach_*``) calls over the whole parameter list; moments are f32
on the parameters' device.
"""

from __future__ import annotations

import math
import re

import torch

from ..config import ModelConfig, TrainConfig
from ..models.model import Model

_CNN_STAGE = re.compile(r"^cnn\.stages\.(\d+)\.(down|blocks\.(\d+))\.")


def learning_rate(count: int, base_learning_rate: float, warmup_steps: int,
                  cosine_decay_steps: int) -> float:
    """Linear 0 -> base over ``warmup_steps``, then cosine decay to 0 over
    ``cosine_decay_steps`` counted from the boundary (optax's
    ``join_schedules`` of ``linear_schedule`` and ``cosine_decay_schedule``)."""
    if count < warmup_steps:
        return base_learning_rate * count / warmup_steps
    progress = min(count - warmup_steps, cosine_decay_steps) / cosine_decay_steps
    return base_learning_rate * 0.5 * (1.0 + math.cos(math.pi * progress))


def max_conv_depth(model_cfg: ModelConfig) -> int:
    return sum(model_cfg.depths)  # the deepest block's depth


def lr_decay_factors(names: list[str], model_cfg: ModelConfig, decay: float) -> list[float]:
    """Per-parameter LR multipliers of the layer-wise decay, by state_dict
    name: ``decay ** (max_depth - depth)`` inside the CNN stages, else 1."""
    max_depth = max_conv_depth(model_cfg)
    factors = []
    for name in names:
        m = _CNN_STAGE.match(name)
        if m is None:
            factors.append(1.0)
            continue
        depth = sum(model_cfg.depths[:int(m.group(1))])
        if m.group(3) is not None:
            depth += int(m.group(3)) + 1
        factors.append(decay ** (max_depth - depth))
    return factors


class LayerwiseAdamW:
    """The update chain over a model's parameters, with its state: the Adam
    moments and the step count.  :meth:`update` turns gradients into
    updates and advances the state; :meth:`apply` adds updates to the
    parameters in place."""

    def __init__(self, model: Model, model_cfg: ModelConfig, train_cfg: TrainConfig):
        named = list(model.named_parameters())
        self.names = [name for name, _ in named]
        self.params = [p for _, p in named]
        for name, p in named:
            if p.dtype != torch.float32:
                raise ValueError(f"{name} is {p.dtype}: the optimizer updates f32 parameters "
                                 "(the compute dtype is applied at use, not stored)")
        self.cfg = train_cfg
        self.factors = lr_decay_factors(self.names, model_cfg, train_cfg.layer_lr_decay)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def learning_rate(self) -> float:
        """The schedule at the current count (the next update's rate)."""
        c = self.cfg
        return learning_rate(self.count, c.base_learning_rate, c.warmup_steps, c.num_steps)

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """Gradients (f32, in parameter order) -> updates; advances the
        moments and the count."""
        c = self.cfg
        lr = self.learning_rate()
        self.count += 1
        torch._foreach_lerp_(self.mu, grads, 1.0 - c.adam_b1)
        torch._foreach_mul_(self.nu, c.adam_b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - c.adam_b2)
        denom = torch._foreach_div(self.nu, 1.0 - c.adam_b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, c.adam_eps)
        updates = torch._foreach_div(self.mu, 1.0 - c.adam_b1 ** self.count)
        torch._foreach_div_(updates, denom)
        torch._foreach_add_(updates, self.params, alpha=c.weight_decay)
        torch._foreach_mul_(updates, [-lr * f for f in self.factors])
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(updates)))
        clip = torch.where(norm < c.global_norm_clip, torch.ones_like(norm),
                           c.global_norm_clip / norm)
        torch._foreach_mul_(updates, clip)
        return updates

    @torch.no_grad()
    def apply(self, updates: list[torch.Tensor]) -> None:
        torch._foreach_add_(self.params, updates)


def setup_optimizers(model: Model, model_cfg: ModelConfig,
                     train_cfg: TrainConfig) -> LayerwiseAdamW:
    """The optimizer of ``model``'s parameters.  ``fused_flat_optimizer`` is a
    no-op: the chain already runs as multi-tensor calls."""
    if train_cfg.ensemble_size > 1:
        raise NotImplementedError(
            f"ensemble_size={train_cfg.ensemble_size}: the ensemble axis arrives with the "
            "port's parallel/ package (slice 3); train one member until then")
    return LayerwiseAdamW(model, model_cfg, train_cfg)
