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
is one scalar per parameter.  A population gets one chain per member
(:class:`EnsembleOptimizer`).  The chain runs on flat f32 buffers on the
parameters' device -- the moments, the gradients and the updates, each
parameter's moment a view into its buffer -- with the count on the device
and the schedule, bias corrections included, computed there in f32.  The
step's validity enters as a device tensor: an invalid step leaves
parameters, moments and count as they were, and the host never reads the
card.

Under tensor parallelism (a model sharded by ``parallel.tp.shard_params_tp``)
each rank holds the moments of its own slices, and the clip's global norm
counts every replicated parameter once and sums the squares of the sharded
ones over the model ranks (optax's norm over the global arrays), so every
rank scales by the same factor.  On an ensemble axis each rank updates its
one member.
"""

from __future__ import annotations

import math
import re

import torch

from ..config import ModelConfig, TrainConfig
from ..models.model import Ensemble, Model
from ..parallel.mesh import ENSEMBLE_AXIS, Mesh

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
        device = self.params[0].device
        self._sizes = [p.numel() for p in self.params]
        total = sum(self._sizes)
        self._mu_flat = torch.zeros(total, dtype=torch.float32, device=device)
        self._nu_flat = torch.zeros(total, dtype=torch.float32, device=device)
        self.mu = self._views(self._mu_flat)
        self.nu = self._views(self._nu_flat)
        self._factors_flat = torch.cat([torch.full((n,), f, dtype=torch.float32)
                                        for n, f in zip(self._sizes, self.factors)]).to(device)
        self._count = torch.zeros((), dtype=torch.int64, device=device)
        self._tp = getattr(model, "tp", None)
        if self._tp is not None:
            sharded = torch.tensor([name in self._tp.sharded for name in self.names])
            self._sharded = sharded.to(device)

    def _views(self, flat: torch.Tensor) -> list[torch.Tensor]:
        return [v.view_as(p) for v, p in zip(flat.split(self._sizes), self.params)]

    @property
    def count(self) -> int:
        """Updates applied so far (reads the device)."""
        return int(self._count)

    def learning_rate(self) -> float:
        """The schedule at the current count (the next update's rate; reads
        the device)."""
        c = self.cfg
        return learning_rate(self.count, c.base_learning_rate, c.warmup_steps, c.num_steps)

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor],
               valid: torch.Tensor | None = None) -> list[torch.Tensor]:
        """Gradients (f32, in parameter order) -> updates, one view per
        parameter; advances the moments and the count.  Where the 0-d bool
        ``valid`` is False (default: True), the updates are zeros and the
        moments and count stay as they were.  No value passes through the
        host."""
        c = self.cfg
        if valid is None:
            valid = torch.ones((), dtype=torch.bool, device=self._count.device)
        g = torch.where(valid, torch.cat([t.reshape(-1) for t in grads]), 0.0)
        before = self._count.to(torch.float32)
        count = before + 1.0
        mu = torch.lerp(self._mu_flat, g, 1.0 - c.adam_b1)
        nu = self._nu_flat * c.adam_b2
        nu.addcmul_(g, g, value=1.0 - c.adam_b2)
        denom = (nu / (1.0 - c.adam_b2 ** count)).sqrt_().add_(c.adam_eps)
        updates = mu / (1.0 - c.adam_b1 ** count)
        updates.div_(denom)
        updates.add_(torch.cat([p.reshape(-1) for p in self.params]), alpha=c.weight_decay)
        updates.mul_(self._factors_flat * -self._schedule(before))
        norms = torch.stack(torch._foreach_norm(list(updates.split(self._sizes))))
        if self._tp is None:
            norm = torch.linalg.vector_norm(norms)
        else:
            squares = norms.square()
            sharded = self._tp.all_reduce(torch.where(self._sharded, squares, 0.0).sum())
            norm = (sharded + torch.where(self._sharded, 0.0, squares).sum()).sqrt()
        updates.mul_(torch.where(norm < c.global_norm_clip, torch.ones_like(norm),
                                 c.global_norm_clip / norm))
        self._mu_flat.copy_(torch.where(valid, mu, self._mu_flat))
        self._nu_flat.copy_(torch.where(valid, nu, self._nu_flat))
        self._count.add_(valid.to(torch.int64))
        return self._views(torch.where(valid, updates, 0.0))

    @torch.no_grad()
    def apply(self, updates: list[torch.Tensor]) -> None:
        torch._foreach_add_(self.params, updates)

    def snapshot(self) -> dict[str, torch.Tensor]:
        """Host copies of the moments and the count."""
        return {name: t.detach().to("cpu", copy=True) for name, t in
                (("mu", self._mu_flat), ("nu", self._nu_flat), ("count", self._count))}

    @torch.no_grad()
    def restore(self, snap: dict[str, torch.Tensor]) -> None:
        self._mu_flat.copy_(snap["mu"])
        self._nu_flat.copy_(snap["nu"])
        self._count.copy_(snap["count"])

    def _schedule(self, count: torch.Tensor) -> torch.Tensor:
        """:func:`learning_rate` on the device, f32."""
        c = self.cfg
        warm = c.base_learning_rate * count / max(c.warmup_steps, 1)
        progress = torch.clamp(count - c.warmup_steps, max=c.num_steps) / c.num_steps
        cosine = c.base_learning_rate * 0.5 * (1.0 + torch.cos(math.pi * progress))
        return torch.where(count < c.warmup_steps, warm, cosine)


def schedule(train_cfg: TrainConfig):
    """The learning rate at a count: the optax schedule of the JAX
    package's ``setup_optimizers``."""
    return lambda count: learning_rate(count, train_cfg.base_learning_rate,
                                       train_cfg.warmup_steps, train_cfg.num_steps)


class EnsembleOptimizer:
    """One :class:`LayerwiseAdamW` per member of an ``Ensemble``: the JAX
    package's ``vmap(tx.init)`` over the population axis.  ``members[i]``
    updates member i's parameters; each keeps its own moments and count."""

    def __init__(self, ensemble: Ensemble, model_cfg: ModelConfig, train_cfg: TrainConfig):
        self.members = [LayerwiseAdamW(m, model_cfg, train_cfg) for m in ensemble]

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for opt in self.members for p in opt.params]

    @property
    def counts(self) -> list[int]:
        """Updates applied so far, per member (reads the device)."""
        return [opt.count for opt in self.members]

    def snapshot(self) -> list[dict[str, torch.Tensor]]:
        return [opt.snapshot() for opt in self.members]

    def restore(self, snaps: list[dict[str, torch.Tensor]]) -> None:
        for opt, snap in zip(self.members, snaps, strict=True):
            opt.restore(snap)


def local_members(train_cfg: TrainConfig, mesh: Mesh | None = None) -> int:
    """The members each rank holds: the population, or one per ensemble
    index on an ensemble axis."""
    return train_cfg.ensemble_size // (1 if mesh is None else mesh.extent(ENSEMBLE_AXIS))


def setup_optimizers(model: Model | Ensemble, model_cfg: ModelConfig,
                     train_cfg: TrainConfig,
                     mesh: Mesh | None = None) -> LayerwiseAdamW | EnsembleOptimizer:
    """The optimizer of ``model``'s parameters: a :class:`LayerwiseAdamW` for
    one member, an :class:`EnsembleOptimizer` for an ``Ensemble`` of
    ``train_cfg.ensemble_size`` (of :func:`local_members` on ``mesh``).
    ``fused_flat_optimizer`` is a no-op: the chain already runs as
    multi-tensor calls."""
    size = local_members(train_cfg, mesh)
    if isinstance(model, Ensemble) != (size > 1) or (size > 1 and len(model) != size):
        raise ValueError(f"ensemble_size={size} needs "
                         + (f"an Ensemble of {size} members" if size > 1 else "one Model")
                         + " (models/model.init_ensemble)")
    if size > 1:
        return EnsembleOptimizer(model, model_cfg, train_cfg)
    return LayerwiseAdamW(model, model_cfg, train_cfg)
