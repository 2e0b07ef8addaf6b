"""The training loop: the input feed, loss scaling with rollback,
checkpoints, metrics, test-set evaluation and the population's evolution.

Counterpart of ``audio_to_midi_tpu/train/loop.py``.
Reference semantics (train.py:211-452):
  * with loss scaling (f16 compute), a host snapshot of the parameters and
    the optimizer state every ``recovery_snapshot_every`` steps; on a
    non-finite step, halve the grad scale and roll back; double the scale
    whenever the scaled loss drops below ``loss_scale_increase_threshold``;
  * a checkpoint on every step the manager allows, and a forced final one;
  * train/loss (the least over the members), the learning rate and steps/s
    every ``print_every`` steps (and the input ring's reuse telemetry);
    per-test-set loss, hit rate and eventized diff every
    ``testset_loss_every``;
  * with a population of more than 2 (``ensemble_size``), genetic evolution
    after each evaluation (``train/ensemble.py``), scored by the mean test
    loss over the test sets; the children are written into the members'
    parameters in place, and the optimizer keeps its moments, as in JAX.

The feed, as in JAX: by default the device-resident input ring
(``data/device_ring.py``) with the augmentations on the device; with
``input_ring_capacity=0`` a host batch per step, augmented on the device
when ``augment_on_device``; neither when the loader augments on the host (a
host-augmented window must not be reused).

Every random draw of the loop -- ring sampling, augmentation, the seed of
each minibatch's dropout -- comes from one CPU ``torch.Generator``, so the
host never waits on the card for a seed.  The step keeps its guard on the
card and the host reads a step's ``grads_valid`` one step later, so that
one step can stay in flight (the loss is read every ``print_every``
steps, and a checkpoint reads the parameters).  With loss
scaling the rollback needs the current step's verdict, and the loop reads
it at once, as JAX does: a step where any member went non-finite rolls
every member back.  The numpy generator of each evolution is seeded from
the same CPU generator.

On a mesh of several ranks (``mesh=``, the one the model was placed on:
``parallel.place_model``), as JAX's multi-host loop: each rank's
``data_loader`` yields its local shard, ``batch_size // world`` windows; the
ring runs in mesh mode with the lockstep refresh (a host batch per step is
gathered over the world instead), and every rank draws from the same
generator state, so the host decisions agree without a collective.  Under
TP the fused layer kernels (``"pallas_block"``, ``"pallas_pair"``,
``"pallas_fused"``) become ``"xla"``, as in JAX; ``"pallas"`` and
``"pallas_rw"`` keep their kernels on the local heads.  Checkpoints: every
rank takes part in gathering the full layout (``(E,)``-leading for a
population), rank 0 writes it, the others wait at a barrier.  Test-set
evaluation runs on every rank in lockstep, and on an ensemble axis its
scores are gathered over ``"ensemble"``; the evolution gathers the
population in full layout on every rank, runs the same
``evolve_model_ensemble`` with the same seed everywhere, and each rank
copies its own members back in place.
"""

from __future__ import annotations

import dataclasses
import logging
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from ..config import Config
from ..data.augment_device import transform_for_training_device
from ..data.device_ring import DeviceInputRing, _Feeder
from ..models.model import Ensemble, Model
from ..models.rope import RopeFreqs
from ..parallel.mesh import (DATA_AXIS, ENSEMBLE_AXIS, MODEL_AXIS, Mesh, gather_params,
                             local_minibatches, param_digest, tp_active)
from . import checkpoint as ckpt
from .ensemble import evolve_ensemble_
from .evaluate import compute_testset_loss
from .optim import EnsembleOptimizer, LayerwiseAdamW
from .step import make_train_step, reshape_to_minibatches

log = logging.getLogger(__name__)


def _snapshot(model: Model | Ensemble,
              optimizer: LayerwiseAdamW | EnsembleOptimizer) -> tuple[dict, Any]:
    params = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return params, optimizer.snapshot()


def _warn_skipped(step: int, valid: torch.Tensor) -> None:
    """Report a step whose update the guard skipped, for one member or for
    some members of a population (reads the card)."""
    if not bool(valid.all()):
        log.warning("Non-finite grads/loss at step %d%s; the update was skipped", step,
                    f" (members valid={valid.cpu().numpy()})" if valid.dim() else "")


def train(
    cfg: Config,
    model: Model | Ensemble,
    state: dict,
    optimizer: LayerwiseAdamW | EnsembleOptimizer,
    data_loader: Iterable,
    checkpoint_manager: Optional[ckpt.CheckpointManager],
    learning_rate_schedule: Callable[[int], float],
    rope: RopeFreqs,
    num_model_output_frames: int,
    testset_dirs: Optional[dict[str, Path]] = None,
    summary_writer=None,
    num_steps: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    step_hook: Optional[Callable[[int, dict[str, Any]], None]] = None,
    mesh: Optional[Mesh] = None,
):
    """Run the training loop on ``model``'s device: a ``Model``, or an
    ``Ensemble`` of ``cfg.train.ensemble_size`` members; ``optimizer`` must
    be the model's.  ``data_loader`` yields (events, audio) host batches.
    ``mesh``: the ranks' layout the model was placed on (this rank's member
    on an ensemble axis).  Returns (model, state, optimizer), trained in
    place."""
    multihost = mesh is not None and mesh.size > 1
    if not multihost:
        mesh = None
    testset_dirs = testset_dirs or {}
    if testset_dirs and cfg.train.ensemble_size == 3:
        raise ValueError("ensemble_size 3 cannot evolve (one winner, and a child needs two "
                         "parents): train 2 members or at least 4 with test sets")
    num_steps = num_steps or cfg.train.num_steps
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    device = next(model.parameters()).device
    if tp_active(mesh) and cfg.model.attention_impl not in ("pallas", "pallas_rw", "xla"):
        # The fused layer kernels hold whole weights: not head-shardable.
        log.info('model axis %d active: forcing attention_impl="xla" for TP (megakernel impl '
                 "%s is not head-shardable)", mesh.extent(MODEL_AXIS),
                 cfg.model.attention_impl)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                 attention_impl="xla"))
    elif tp_active(mesh) and cfg.model.attention_impl != "xla":
        log.info("model axis %d active: attention kernels on the %d local heads",
                 mesh.extent(MODEL_AXIS),
                 cfg.model.num_transformer_heads // mesh.extent(MODEL_AXIS))
    train_step = make_train_step(cfg, optimizer, rope, mesh)

    device_augment = cfg.train.augment_on_device and cfg.transforms is not None
    # A loader built with transform_settings augments on the host whatever
    # the config says: trust the loader, so such a feed is never augmented
    # twice or reused from the ring.
    loader_host_augments = getattr(data_loader, "transform_settings", None) is not None
    if loader_host_augments and device_augment:
        warnings.warn(
            "data_loader was built with transform_settings (host augmentation) but "
            "cfg.train.augment_on_device is True; disabling on-device augmentation and the "
            "input ring for this run. Build the loader with transform_settings=None to use "
            "the device-augmented ring feed.",
            stacklevel=2,
        )
        device_augment = False
    host_augmented_feed = loader_host_augments or (
        cfg.transforms is not None and not cfg.train.augment_on_device)
    use_ring = cfg.train.input_ring_capacity > 0 and not host_augmented_feed
    ring_settings = cfg.transforms if device_augment else None

    start_step = 1
    latest = checkpoint_manager.latest_step() if checkpoint_manager is not None else None
    if latest is not None:
        start_step = latest + 1
    batch_size = cfg.train.batch_size
    data_extent = mesh.extent(DATA_AXIS) if multihost else 1
    # Clamped for tiny batches: one accumulation step.
    minibatch = min(cfg.train.minibatch_size_per_device * data_extent, batch_size)
    if multihost and (batch_size % mesh.size or minibatch % mesh.size):
        raise ValueError(
            f"batch_size {batch_size} and minibatch {minibatch} must both "
            f"divide over {mesh.size} processes"
        )

    grad_scale = 1.0
    use_loss_scaling = cfg.precision.needs_loss_scaling
    recovery = _snapshot(model, optimizer) if use_loss_scaling else None
    loss_sum = torch.zeros((cfg.train.ensemble_size,), dtype=torch.float32, device=device)
    loss_count = 0
    prev_valid = None
    t_start = time.time()
    step = start_step - 1

    data_iter = iter(data_loader)
    if use_ring:
        # Window shapes come from the first feed chunk.
        ring = DeviceInputRing(cfg.train.input_ring_capacity, batch_size, device=device,
                               mesh=mesh)
        feeder = _Feeder(data_iter, pin_memory=device.type == "cuda")
        min_fill = min(batch_size, ring.capacity)

    for step in range(start_step, num_steps + 1):
        if use_ring:
            refresh = step % max(cfg.train.input_ring_refresh_period, 1) == 0
            if multihost:
                ring.pull_lockstep(feeder, min_fill=min_fill, refresh_chunks=1 if refresh else 0)
            else:
                ring.pull(feeder, min_fill=min_fill, max_chunks=1 if refresh else 0)
            audio_mb, events_mb = ring.sample(generator, batch_size, minibatch, ring_settings)
        else:
            try:
                events, audio = next(data_iter)
            except StopIteration:
                step -= 1  # no step ran for this iteration
                break
            # The wire is f16: decoded audio is already f16-rounded.
            audio = torch.from_numpy(np.asarray(audio, np.float16)).to(device)
            events = torch.from_numpy(np.asarray(events, np.float16)).to(device)
            if multihost:
                # Each rank's local shard -> the global batch on every rank.
                audio, events = (mesh.all_gather(t, None).flatten(0, 1) for t in (audio, events))
            if device_augment:
                audio, events = transform_for_training_device(
                    audio, events, cfg.transforms, generator)
            audio_mb = local_minibatches(reshape_to_minibatches(audio, minibatch), mesh)
            events_mb = local_minibatches(reshape_to_minibatches(events, minibatch), mesh)

        if use_loss_scaling and step % cfg.train.recovery_snapshot_every == 0:
            recovery = _snapshot(model, optimizer)

        out = train_step(model, audio_mb, events_mb, grad_scale, generator)
        loss = out.loss

        if prev_valid is not None:
            # The guard in the step already skipped the update on the card;
            # read one step late so that one step stays in flight.
            _warn_skipped(step - 1, prev_valid)
        prev_valid = out.grads_valid

        if use_loss_scaling:
            if not bool(out.grads_valid.all()) or not bool(torch.isfinite(loss).all()):
                new_scale = grad_scale / 2
                log.warning("Non-finite grads/loss at step %d; rolling back, grad scale %s -> %s",
                            step, grad_scale, new_scale)
                grad_scale = new_scale
                with torch.no_grad():
                    model.load_state_dict(recovery[0])
                optimizer.restore(recovery[1])
                prev_valid = None  # rolled back, not merely skipped
                continue
            if bool((out.scaled_loss < cfg.train.loss_scale_increase_threshold).all()):
                grad_scale = grad_scale * 2

        if checkpoint_manager is not None and ckpt.save_checkpoint(
                checkpoint_manager, step, model, state, mesh=mesh, latest=latest):
            latest = step

        # Non-finite losses (their updates were skipped) stay out of the average.
        loss_sum += torch.where(torch.isfinite(loss), loss, 0.0)
        loss_count += 1

        if step % cfg.train.print_every == 0:
            averaged = loss_sum.cpu().numpy().astype(np.float64) / max(loss_count, 1)
            lr = float(learning_rate_schedule(step))
            steps_per_s = loss_count / max(time.time() - t_start, 1e-9)
            log.info("step %d/%d loss=%s lr=%.3g steps/s=%.2f", step, num_steps, averaged, lr,
                     steps_per_s)
            ring_stats = ring.take_stats(cfg.train.input_ring_reuse_warn_factor) if use_ring \
                else None
            if summary_writer is not None:
                summary_writer.add_scalar("train/loss", float(np.min(averaged)), step)
                summary_writer.add_scalar("train/learning_rate", lr, step)
                summary_writer.add_scalar("train/steps_per_sec", steps_per_s, step)
                if ring_stats is not None:
                    summary_writer.add_scalar("train/ring_reuse_factor",
                                              ring_stats["reuse_factor"], step)
                    summary_writer.add_scalar("train/ring_refreshed_windows",
                                              ring_stats["interval_refreshed_windows"], step)
                    summary_writer.add_scalar("train/ring_filled", ring_stats["filled"], step)
                summary_writer.flush()
            if step_hook is not None:
                step_hook(step, {"loss": averaged, "lr": lr, "steps_per_s": steps_per_s,
                                 "grad_scale": grad_scale, "ring": ring_stats})
            loss_sum.zero_()
            loss_count = 0
            t_start = time.time()

        if testset_dirs and step % cfg.train.testset_loss_every == 0:
            testset_losses = []
            for name, testset_dir in testset_dirs.items():
                # The figures go to the summary writer: none are drawn without
                # one (the card's machine has no matplotlib).
                test_loss, hit_rate, eventized_diff, figs = compute_testset_loss(
                    model, cfg, testset_dir, num_model_output_frames, rope,
                    generate_visualizations=None if summary_writer is not None else False)
                if multihost and mesh.extent(ENSEMBLE_AXIS) > 1:
                    test_loss, hit_rate, eventized_diff = (
                        mesh.all_gather(torch.from_numpy(np.asarray(v)), ENSEMBLE_AXIS)
                        .reshape(-1).numpy() for v in (test_loss, hit_rate, eventized_diff))
                log.info("testset %s: loss=%s hit_rate=%s eventized_diff=%s", name, test_loss,
                         hit_rate, eventized_diff)
                testset_losses.append(test_loss)
                if summary_writer is not None:
                    summary_writer.add_scalar(f"train/test-loss-{name}", float(test_loss[0]), step)
                    summary_writer.add_scalar(f"train/test-hit-rate-{name}", float(hit_rate[0]),
                                              step)
                    summary_writer.add_scalar(f"train/test-eventized-diff-{name}",
                                              float(eventized_diff[0]), step)
                    for i, fig in enumerate(figs):
                        summary_writer.add_figure(f"train/test-loss-{name}-{i}", fig, step)
                if figs:
                    # add_figure rendered them; release pyplot's references
                    # (open figures hold host memory on long runs).
                    import matplotlib.pyplot as plt

                    for fig in figs:
                        plt.close(fig)
            if summary_writer is not None:
                summary_writer.flush()

            if cfg.train.ensemble_size > 2:
                scores = np.mean(np.stack(testset_losses), axis=0)
                seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
                t0 = time.perf_counter()
                regenerated = evolve_ensemble_(model, scores, np.random.default_rng(seed), mesh)
                log.info("step %d: evolved the population on scores %s; regenerated members %s "
                         "in %.1f ms", step, scores, regenerated,
                         (time.perf_counter() - t0) * 1e3)

    if prev_valid is not None:
        _warn_skipped(step, prev_valid)
    if multihost:
        # The full layout's digest: equal on every rank of a run whose
        # replicas stayed in step.
        full = gather_params(model, mesh)
        log.info("rank %d: parameter digest %d", mesh.rank,
                 param_digest([torch.from_numpy(full[k]) for k in sorted(full)]))
    # A final save, so that short runs still leave a checkpoint; skipped if
    # the last step saved already or no step ran.
    if checkpoint_manager is not None and step >= start_step and latest != step:
        ckpt.save_checkpoint(checkpoint_manager, step, model, state, force=True, mesh=mesh)
    return model, state, optimizer
