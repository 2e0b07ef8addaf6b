"""The port's training loop against the JAX package's: step for step (losses
and final parameters, f32, ring off, no dropout or transforms), the
loss-scaling rollback, the guard read one step late, the ring feed and the
host-augmenting loader.  The rest of the entry point (init, checkpoints,
metrics, evaluation, the CLIs) is in tests/test_torch_train_entry.py."""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu.data import loader as jax_loader
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.parallel import make_mesh, shard_params
from audio_to_midi_tpu.train import loop as jax_loop
from audio_to_midi_tpu.train import setup_optimizers as jax_setup_optimizers
from audio_to_midi_tpu_torch import config as pt_config
from audio_to_midi_tpu_torch.convert import flatten_tree, jax_to_state_dict, state_dict_to_jax
from audio_to_midi_tpu_torch.data import loader as pt_loader
from audio_to_midi_tpu_torch.data import synthetic
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.train import loop as pt_loop
from audio_to_midi_tpu_torch.train.optim import schedule, setup_optimizers
from tests.test_e2e import E2E_CFG

torch.set_num_threads(2)

# E2E_CFG (0.5 s windows -> 800 frames, a 2-stage CNN, one layer pair),
# dropout-free, ring off, no transforms: the loop's comparison config.
JAX_CFG = dataclasses.replace(
    E2E_CFG,
    model=dataclasses.replace(E2E_CFG.model, transformer_dropout_rate=0.0),
    train=dataclasses.replace(E2E_CFG.train, input_ring_capacity=0, checkpoint_every=1000),
    transforms=None,
)
FRAMES = 800
STEPS = 3


def port_cfg(jax_cfg=JAX_CFG) -> pt_config.Config:
    """The JAX config in the port.  JAX's minibatch is the per-device size
    times the mesh's data extent (8 virtual CPU devices), clamped to the
    batch; the port's single device takes that minibatch."""
    cfg = pt_config.config_from_json(jax_config.config_to_json(jax_cfg))
    minibatch = min(jax_cfg.train.minibatch_size_per_device * len(jax.devices()),
                    jax_cfg.train.batch_size)
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, minibatch_size_per_device=minibatch))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_loop")
    synthetic.make_synthetic_dataset(d, num_samples=2, duration_s=0.8, notes_per_sample=3,
                                     seed=5)
    return d


@pytest.fixture(scope="module")
def jax_run(dataset):
    """JAX's loop.train over STEPS steps: initial member-0 params, losses by
    step_hook, final member-0 params."""
    cfg = JAX_CFG
    mesh = make_mesh(1)
    rope = jax_model.make_rope(cfg.model)
    params, state = jax_model.init_ensemble(jax.random.PRNGKey(0), cfg.model, 1)
    init = flatten_tree(jax.tree.map(lambda x: np.asarray(x[0]), params))
    params = shard_params(params, mesh)
    tx, sched = jax_setup_optimizers(params, cfg.model, cfg.train, ensemble=True)
    opt_state = jax.vmap(tx.init)(params)
    losses = []
    with jax_loader.ThreadedBatchLoader(dataset, cfg.train.batch_size, FRAMES, None,
                                        num_workers=1, audio_duration=0.5) as data:
        params, _, _ = jax_loop.train(
            cfg, params, state, tx, opt_state, data, None, sched, rope, FRAMES, mesh=mesh,
            step_hook=lambda step, info: losses.append(float(info["loss"][0])))
    final = flatten_tree(jax.tree.map(lambda x: np.asarray(x[0]), params))
    return init, losses, final


def _model_from(flat, cfg) -> pt_model.Model:
    model = pt_model.Model(cfg.model)
    model.load_state_dict(jax_to_state_dict(flat))
    return model


# --- the loop -------------------------------------------------------------------


def test_loop_matches_jax_step_for_step(dataset, jax_run):
    init, jax_losses, jax_final = jax_run
    cfg = port_cfg()
    assert cfg.train.minibatch_size_per_device == 8 and cfg.transforms is None
    model = _model_from(init, cfg)
    optimizer = setup_optimizers(model, cfg.model, cfg.train)
    losses = []
    with pt_loader.ThreadedBatchLoader(dataset, cfg.train.batch_size, FRAMES, None,
                                       num_workers=1, audio_duration=0.5) as data:
        pt_loop.train(cfg, model, {}, optimizer, data, None, schedule(cfg.train),
                      pt_model.make_rope(cfg.model), FRAMES,
                      step_hook=lambda step, info: losses.append(float(info["loss"][0])))
    assert len(losses) == len(jax_losses) == STEPS
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    assert optimizer.count == STEPS
    final = state_dict_to_jax(model.state_dict())
    moved = 0
    for path, ref in jax_final.items():
        scale = np.abs(ref).max()
        assert np.abs(final[path] - ref).max() <= 1e-5 * scale, path
        moved += not np.array_equal(ref, init[path])
    assert moved > len(jax_final) // 2


def test_the_guarded_update_is_the_update_and_skips_on_the_card():
    """The chain's schedule on the device against the host's double-precision
    one (relative 1e-6, warm-up and cosine); the update under a True guard
    is the unguarded update bit for bit; a False guard changes nothing."""
    cfg = port_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, warmup_steps=2,
                                                             num_steps=5))
    models = [pt_model.init(torch.Generator().manual_seed(7), cfg.model)[0] for _ in range(2)]
    opts = [setup_optimizers(m, cfg.model, cfg.train) for m in models]
    for count in range(10):
        np.testing.assert_allclose(float(opts[0]._schedule(torch.tensor(float(count)))),
                                   schedule(cfg.train)(count), rtol=1e-6, atol=0)
    rng = np.random.default_rng(0)
    for _ in range(4):
        grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
                 for p in opts[0].params]
        opts[0].apply(opts[0].update(grads))
        opts[1].apply(opts[1].update(grads, torch.tensor(True)))
    assert opts[0].count == opts[1].count == 4
    assert all(torch.equal(a, b) for a, b in zip(opts[0].params + opts[0].mu + opts[0].nu,
                                                 opts[1].params + opts[1].mu + opts[1].nu))
    before = [t.clone() for t in opts[1].params + opts[1].mu + opts[1].nu]
    grads[0][0] = float("nan")
    opts[1].apply(opts[1].update(grads, torch.tensor(False)))
    assert opts[1].count == 4
    assert all(torch.equal(a, b) for a, b in zip(before, opts[1].params + opts[1].mu
                                                 + opts[1].nu))


def _batches(cfg, count, nan_at=None, seed=0):
    rng = np.random.default_rng(seed)
    b, n = cfg.train.batch_size, cfg.data.samples_per_window
    for i in range(count):
        audio = rng.standard_normal((b, 2, n)).astype(np.float32)
        labels = (rng.random((b, FRAMES, 90)) > 0.95).astype(np.float32)
        if i == nan_at:
            labels[0, 0, 0] = np.nan
        yield labels, audio


def test_loss_scaling_rolls_back_a_nan_step(caplog):
    cfg = port_cfg()
    cfg = dataclasses.replace(cfg, precision=pt_config.PrecisionConfig("f32", "f16"),
                              train=dataclasses.replace(cfg.train, num_steps=2))
    model, _ = pt_model.init(torch.Generator().manual_seed(4), cfg.model)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = setup_optimizers(model, cfg.model, cfg.train)
    seen = []
    with caplog.at_level(logging.WARNING):
        pt_loop.train(cfg, model, {}, optimizer, _batches(cfg, 2, nan_at=1), None,
                      schedule(cfg.train), pt_model.make_rope(cfg.model), FRAMES,
                      step_hook=lambda step, info: seen.append((step, info["grad_scale"])))
    assert seen == [(1, 1.0)]  # step 2 rolled back, so it logs nothing
    assert "rolling back, grad scale 1.0 -> 0.5" in caplog.text
    # The snapshot is the loop's start: step 1's update is rolled back too.
    assert all(torch.equal(v, initial[k]) for k, v in model.state_dict().items())
    assert optimizer.count == 0 and not optimizer._mu_flat.any()


def test_a_nan_step_is_skipped_on_the_card_and_reported_a_step_late(caplog):
    cfg = port_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, num_steps=3))
    model, _ = pt_model.init(torch.Generator().manual_seed(4), cfg.model)
    optimizer = setup_optimizers(model, cfg.model, cfg.train)
    with caplog.at_level(logging.WARNING):
        pt_loop.train(cfg, model, {}, optimizer, _batches(cfg, 3, nan_at=1), None,
                      schedule(cfg.train), pt_model.make_rope(cfg.model), FRAMES)
    assert "Non-finite grads/loss at step 2; the update was skipped" in caplog.text
    assert optimizer.count == 2
    assert all(torch.isfinite(p).all() for p in model.parameters())


class _Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def flush(self):
        pass


def test_the_ring_loop_runs_with_its_stats_in_step_hook(dataset):
    cfg = port_cfg()
    cfg = dataclasses.replace(
        cfg, transforms=pt_config.TransformSettings(),
        train=dataclasses.replace(cfg.train, num_steps=4, input_ring_capacity=16,
                                  testset_loss_every=4))
    model, _ = pt_model.init(torch.Generator().manual_seed(5), cfg.model)
    before = [p.detach().clone() for p in model.parameters()]
    optimizer = setup_optimizers(model, cfg.model, cfg.train)
    seen, writer = [], _Writer()
    pt_loop.train(cfg, model, {}, optimizer, _batches(cfg, 2), None, schedule(cfg.train),
                  pt_model.make_rope(cfg.model), FRAMES, testset_dirs={"synth": dataset},
                  summary_writer=writer, step_hook=lambda step, info: seen.append(info))
    # The JAX loop's summary names.
    assert {t for t, _, _ in writer.scalars} == {
        "train/loss", "train/learning_rate", "train/steps_per_sec", "train/ring_reuse_factor",
        "train/ring_refreshed_windows", "train/ring_filled", "train/test-loss-synth",
        "train/test-hit-rate-synth", "train/test-eventized-diff-synth"}
    assert len(seen) == 4 and all(info["ring"] is not None for info in seen)
    assert sum(i["ring"]["interval_sampled_windows"] for i in seen) == 4 * cfg.train.batch_size
    assert seen[-1]["ring"]["pushed_windows"] == 16  # a finite source: epoch-style reuse
    assert all(np.isfinite(i["loss"]).all() for i in seen)
    assert any(not torch.equal(a, b) for a, b in zip(before, model.parameters()))


def test_host_augmenting_loader_turns_the_ring_off(dataset):
    cfg = port_cfg()
    cfg = dataclasses.replace(cfg, transforms=pt_config.TransformSettings(),
                              train=dataclasses.replace(cfg.train, num_steps=1,
                                                        input_ring_capacity=16))
    model, _ = pt_model.init(torch.Generator().manual_seed(6), cfg.model)
    seen = []
    with pt_loader.ThreadedBatchLoader(dataset, cfg.train.batch_size, FRAMES, cfg.transforms,
                                       num_workers=1, audio_duration=0.5) as data:
        with pytest.warns(UserWarning, match="host augmentation"):
            pt_loop.train(cfg, model, {}, setup_optimizers(model, cfg.model, cfg.train), data,
                          None, schedule(cfg.train), pt_model.make_rope(cfg.model), FRAMES,
                          step_hook=lambda step, info: seen.append(info))
    assert len(seen) == 1 and seen[0]["ring"] is None
