"""The training step: gradient accumulation over minibatches, mixed precision
with loss scaling, and the non-finite guard.

Counterpart of ``audio_to_midi_tpu/train/step.py`` on one device.
Reference semantics: a loop over minibatches accumulates f32
gradients from a backward pass in the compute dtype; the gradients are
unscaled by ``grad_scale * num_minibatches``, checked for finiteness, and
applied with the layer-wise AdamW chain.  The loss returned is the unscaled
mean.

Differences from the JAX step, which is one jitted pure function:
  * the model's parameters, their ``.grad`` buffers and the optimizer's
    moments are updated in place -- buffer reuse takes the place of donation;
  * the guard stays on the device: ``LayerwiseAdamW.update`` takes the
    step's validity as a tensor, and an invalid step leaves parameters,
    moments and count as they were.  ``grads_valid`` is a 0-d bool tensor
    that the caller reads when it chooses (``bool(out.grads_valid)``): the
    training loop reads it one step later, so that the step never waits
    for the card;
  * activations are saved by autograd and not rematerialized;
  * dropout draws from ``torch.Generator``s instead of split keys: each
    minibatch gets a generator of its own on the model's device, seeded from
    the step's generator, as the JAX step splits its key per minibatch.  The
    same state of the step's generator gives the same step, bit for bit;
  * a population (``ensemble_size > 1``) takes its members in turn where
    JAX vmaps them: every member sees the same batch, and member i's
    generator is seeded with the i-th of E draws taken from the step's
    generator up front (JAX's ``jax.random.split(key, e)``).  Member i's
    part of the step is the one-member step on its weights and generator,
    bit for bit; an invalid member keeps its parameters and moments while
    the others update.

On a mesh of ranks (``parallel.make_mesh``; JAX's ``in_shardings`` and the
all-reduces GSPMD inserts):
  * the batch arrives as this rank's ``"data"`` slice of every minibatch
    (``parallel.local_minibatches``); the minibatch is
    ``minibatch_size_per_device`` times the data extent;
  * the gradients, summed over the minibatches and unscaled, are summed
    over ``"data"`` and divided by its extent, and the loss is its mean
    over ``"data"``, before the guard: every rank takes the same decision;
    under TP the guard's verdict is also taken over ``"model"``, where the
    sharded gradients live;
  * each minibatch's generator is seeded from the step's draw folded with
    the rank's data index (:func:`fold_seed`; index 0 keeps the draw), so
    no two samples share a mask;
  * on an ensemble axis each rank runs its one member with the generator
    member i would get in the population, and ``loss``, ``grads_valid`` and
    ``scaled_loss`` are gathered over ``"ensemble"`` into JAX's ``(E,)``.
With one rank none of this runs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import DTYPES, Config
from ..models.model import Ensemble, Model, member_generators
from ..models.rope import RopeFreqs
from ..parallel.mesh import DATA_AXIS, ENSEMBLE_AXIS, MODEL_AXIS, Mesh, tp_active
from .loss import batch_loss
from .optim import EnsembleOptimizer, LayerwiseAdamW, local_members


class TrainStepOutput(NamedTuple):
    # Each () for one member, (E,) for a population, on the model's device.
    loss: torch.Tensor         # unscaled mean loss
    # Every gradient and the loss finite; else nothing was updated (bool).
    grads_valid: torch.Tensor
    scaled_loss: torch.Tensor  # scaled loss (drives the loss-scale doubling)


def make_train_step(
    cfg: Config, optimizer: LayerwiseAdamW | EnsembleOptimizer, rope: RopeFreqs,
    mesh: Mesh | None = None,
) -> Callable[..., TrainStepOutput]:
    """Build the training step.

    Returned signature:
      step(model, audio, labels, grad_scale, generator=None) -> TrainStepOutput
    with audio (num_minibatches, minibatch, 2, N) and labels
    (num_minibatches, minibatch, F, K) on the model's device.  ``model`` must
    be the one ``optimizer`` was set up for: a ``Model``, or for
    ``ensemble_size > 1`` an ``Ensemble``.  ``generator`` seeds the
    dropout of every minibatch and is needed when the configuration drops
    anything; a CPU generator keeps the host from waiting for the card.
    ``mesh``: the ranks' layout (see the module docstring); with an
    ensemble axis ``model`` is this rank's one member.
    """
    if mesh is not None and mesh.size == 1:
        mesh = None
    size = local_members(cfg.train, mesh)
    if isinstance(optimizer, EnsembleOptimizer) != (size > 1) or (
            size > 1 and len(optimizer.members) != size):
        raise ValueError(f"ensemble_size={size} needs the optimizer of "
                         + (f"an Ensemble of {size} members" if size > 1 else "one Model"))
    if mesh is not None and mesh.extent(ENSEMBLE_AXIS) > 1:
        return _ensemble_axis_step(cfg, optimizer, rope, mesh)
    if size == 1:
        return _member_step(cfg, optimizer, rope, mesh)
    member_steps = [_member_step(cfg, opt, rope, mesh) for opt in optimizer.members]

    def step(ensemble: Ensemble, audio: torch.Tensor, labels: torch.Tensor,
             grad_scale: float | torch.Tensor,
             generator: torch.Generator | None = None) -> TrainStepOutput:
        generators = ([None] * size if generator is None
                      else member_generators(generator, size))
        outs = [member_step(member, audio, labels, grad_scale, g)
                for member_step, member, g in zip(member_steps, ensemble, generators,
                                                   strict=True)]
        return TrainStepOutput(*(torch.stack(values) for values in zip(*outs)))

    return step


def _ensemble_axis_step(cfg: Config, optimizer: LayerwiseAdamW, rope: RopeFreqs,
                        mesh: Mesh) -> Callable[..., TrainStepOutput]:
    """One member per ensemble index: this rank's member step, its outputs
    gathered over ``"ensemble"`` into ``(E,)``."""
    size = cfg.train.ensemble_size
    index = mesh.index(ENSEMBLE_AXIS)
    member_step = _member_step(cfg, optimizer, rope, mesh)

    def step(model: Model, audio: torch.Tensor, labels: torch.Tensor,
             grad_scale: float | torch.Tensor,
             generator: torch.Generator | None = None) -> TrainStepOutput:
        g = None if generator is None else member_generators(generator, size)[index]
        out = member_step(model, audio, labels, grad_scale, g)
        return TrainStepOutput(*(mesh.all_gather(v, ENSEMBLE_AXIS) for v in out))

    return step


def _member_step(cfg: Config, optimizer: LayerwiseAdamW, rope: RopeFreqs,
                 mesh: Mesh | None = None) -> Callable[..., TrainStepOutput]:
    """The step of one member, whose parameters ``optimizer`` updates."""
    compute_dtype = DTYPES[cfg.precision.compute_dtype]
    model_cfg = cfg.model
    data = 1 if mesh is None else mesh.extent(DATA_AXIS)
    data_index = 0 if mesh is None else mesh.index(DATA_AXIS)
    tp = tp_active(mesh)

    def step(model: Model, audio: torch.Tensor, labels: torch.Tensor,
             grad_scale: float | torch.Tensor,
             generator: torch.Generator | None = None) -> TrainStepOutput:
        params = optimizer.params
        num_minibatches = audio.shape[0]
        for p in params:
            p.grad = None
        scaled_losses = []
        with torch.enable_grad():
            for mb_audio, mb_labels in zip(audio, labels):
                scaled_loss = batch_loss(
                    model, model_cfg, mb_audio, mb_labels, rope, grad_scale, compute_dtype,
                    generator=minibatch_generator(generator, mb_audio.device, data_index))
                scaled_loss.backward()  # accumulates into the f32 .grad buffers
                scaled_losses.append(scaled_loss.detach())
        scaled_loss = torch.stack(scaled_losses).mean()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        torch._foreach_div_(grads, grad_scale * num_minibatches)
        if data > 1:
            flat = torch.cat([g.reshape(-1) for g in grads] + [scaled_loss.reshape(1)])
            mesh.all_reduce_(flat, DATA_AXIS).div_(data)
            *parts, scaled_loss = flat.split([g.numel() for g in grads] + [1])
            grads = [part.view_as(g) for part, g in zip(parts, grads)]
            scaled_loss = scaled_loss[0]

        # Always-on non-finite guard (the reference checks every step
        # whatever the precision): a step whose gradients or loss went
        # non-finite is never applied, under bf16 as well as f16.  A leaf's
        # largest magnitude is finite exactly when every element is (it
        # cannot overflow, and a nan propagates): one multi-tensor call
        # instead of a check per leaf.
        largest = torch.stack(torch._foreach_norm(grads, float("inf")))
        valid = largest.isfinite().all() & scaled_loss.isfinite()
        if tp:
            invalid = mesh.all_reduce_((~valid).to(torch.int32), MODEL_AXIS)
            valid = invalid == 0
        optimizer.apply(optimizer.update(grads, valid))
        return TrainStepOutput(scaled_loss / grad_scale, valid, scaled_loss)

    return step


def minibatch_generator(generator: torch.Generator | None, device: torch.device,
                        data_index: int = 0) -> torch.Generator | None:
    """A generator on ``device`` for one minibatch's dropout, seeded with the
    next draw of the step's ``generator`` folded with the rank's
    ``data_index`` (None stays None)."""
    if generator is None:
        return None
    seed = torch.randint(0, 2 ** 62, (), generator=generator, device=generator.device)
    return torch.Generator(device=device).manual_seed(fold_seed(int(seed), data_index))


def fold_seed(seed: int, index: int) -> int:
    """``seed`` decorrelated by ``index`` (a splitmix64 round, 62 bits);
    index 0 keeps it."""
    if index == 0:
        return seed
    z = (seed + index * 0x9E3779B97F4A7C15) & 0xFFFF_FFFF_FFFF_FFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFF_FFFF_FFFF_FFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFF_FFFF_FFFF_FFFF
    return (z ^ (z >> 31)) & (2 ** 62 - 1)


def reshape_to_minibatches(batch: torch.Tensor, minibatch_size: int) -> torch.Tensor:
    """(B, ...) -> (B // m, m, ...) -- the reference's '(b m) ... -> b m ...'."""
    b = batch.shape[0]
    if b % minibatch_size:
        raise ValueError(f"batch {b} is not a multiple of the minibatch {minibatch_size}")
    return batch.reshape(b // minibatch_size, minibatch_size, *batch.shape[1:])
