"""The pieces of the port's training entry point against the JAX package's:
the model initializer, checkpoints, the metrics and the test-set evaluation,
and the training and serving CLIs on a checkpoint directory.  The loop itself
is in tests/test_torch_train_loop.py."""

import dataclasses
import logging
import math

import jax
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu import metrics as jax_metrics
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.train import evaluate as jax_evaluate
from audio_to_midi_tpu_torch import config as pt_config
from audio_to_midi_tpu_torch import infer as pt_infer
from audio_to_midi_tpu_torch import metrics as pt_metrics
from audio_to_midi_tpu_torch.convert import (flatten_tree, jax_to_state_dict, params_to_jax,
                                             state_dict_to_jax)
from audio_to_midi_tpu_torch.data import loader as pt_loader
from audio_to_midi_tpu_torch.data import synthetic
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.ops.midi_io import read_midi_file
from audio_to_midi_tpu_torch.train import checkpoint as ckpt
from audio_to_midi_tpu_torch.train import evaluate as pt_evaluate
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


def _model_from(flat, cfg) -> pt_model.Model:
    model = pt_model.Model(cfg.model)
    model.load_state_dict(jax_to_state_dict(flat))
    return model


# --- init ------------------------------------------------------------------


def _uniform_scale(path: str, flat: dict) -> float:
    """The JAX initializers' bound of a weight or bias: 1/sqrt(fan_in)."""
    w = flat[path.rsplit("/", 1)[0] + "/w"]
    stacked = "/blocks/" in path or path.startswith("transformer/")
    shape = w.shape[1:] if stacked else w.shape
    fan_in = shape[0] if len(shape) == 2 else shape[0] * shape[1]
    return 1.0 / math.sqrt(fan_in)


def test_init_has_jaxs_tree_shapes_and_bounds():
    # Every kind of leaf at a third of the default depth and width.
    jax_model_cfg = dataclasses.replace(jax_config.DEFAULT_CONFIG.model,
                                        dims=(4, 8, 16, 32, 64, 128, 128),
                                        depths=(1, 1, 1, 1, 1, 7, 1), num_transformer_layers=3)
    cfg = port_cfg(dataclasses.replace(JAX_CFG, model=jax_model_cfg))
    model, state = pt_model.init(torch.Generator().manual_seed(0), cfg.model)
    ours = state_dict_to_jax(model.state_dict())
    jax_params, jax_state = jax_model.init(jax.random.PRNGKey(0), jax_model_cfg)
    ref = flatten_tree(jax_params)
    assert state == jax_state == {}
    assert sorted(ours) == sorted(ref)
    for path, value in ours.items():
        assert value.shape == ref[path].shape and value.dtype == np.float32, path
        leaf = path.rsplit("/", 1)[1]
        if leaf in ("scale", "bias", "gamma"):  # LayerNorm ones / zeros, layer scale 1e-6
            assert np.array_equal(value, np.asarray(ref[path])), path
            continue
        bound = _uniform_scale(path, ref)
        for arr in (value, np.asarray(ref[path])):
            assert np.abs(arr).max() <= bound and np.abs(arr).max() > 0.5 * bound, path
        if value.size >= 4096:  # uniform: variance bound^2 / 3
            assert abs(value.std() / (bound / math.sqrt(3)) - 1) < 0.05, path
    again, _ = pt_model.init_ensemble(torch.Generator().manual_seed(0), cfg.model, 1)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    # A population: JAX's init_ensemble layout, a leading (E,) axis per leaf.
    pair, _ = pt_model.init_ensemble(torch.Generator().manual_seed(0), cfg.model, 2)
    assert isinstance(pair, pt_model.Ensemble) and len(pair) == 2
    shapes = jax.eval_shape(lambda k: jax_model.init_ensemble(k, jax_model_cfg, 2)[0],
                            jax.random.PRNGKey(0))
    stacked = params_to_jax(pair)
    assert {k: v.shape for k, v in stacked.items()} == {
        jax.tree_util.keystr(path, simple=True, separator="/"): tuple(v.shape)
        for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}


# --- checkpoints -------------------------------------------------------------


def test_checkpoints_save_restore_keep_and_interval(tmp_path):
    cfg = port_cfg()
    model, _ = pt_model.init(torch.Generator().manual_seed(1), cfg.model)
    manager = ckpt.create_checkpoint_manager(tmp_path / "ck", cfg, max_to_keep=2,
                                             save_interval_steps=3)
    assert manager.latest_step() is None and ckpt.restore_checkpoint(manager, model) is None
    saved = [s for s in range(1, 10) if ckpt.save_checkpoint(manager, s, model, {})]
    assert saved == [3, 6, 9] and manager.all_steps() == [6, 9]  # interval, then max_to_keep
    assert ckpt.save_checkpoint(manager, 10, model, {}, force=True)
    assert manager.all_steps() == [9, 10]
    assert not manager.should_save(9)

    other, _ = pt_model.init(torch.Generator().manual_seed(2), cfg.model)
    other, state, step = ckpt.restore_checkpoint(manager, other)
    assert step == 10 and state == {}
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                   other.state_dict().values()))
    flat, stored_state = manager.restore(10)
    assert stored_state == {} and sorted(flat) == sorted(state_dict_to_jax(model.state_dict()))

    # The serving side reads both the step's file and the directory.
    by_file = pt_infer.load_params(tmp_path / "ck" / "10" / "params.npz", cfg, "cpu")
    by_dir, _ = pt_infer.load_newest_checkpoint(tmp_path / "ck", cfg, "cpu")
    for m in (by_file, by_dir):
        assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                       m.state_dict().values()))
    with pytest.raises(FileNotFoundError):
        pt_infer.load_newest_checkpoint(tmp_path / "empty", cfg, "cpu")


def test_check_metadata_warns_on_drift(tmp_path):
    cfg = port_cfg()
    model, _ = pt_model.init(torch.Generator().manual_seed(1), cfg.model)
    manager = ckpt.create_checkpoint_manager(tmp_path, cfg)
    ckpt.save_checkpoint(manager, 1, model, {}, force=True)
    assert ckpt.check_metadata(manager, cfg)
    assert manager.metadata() == JAX_CFG.metadata()
    drifted = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, sdd_rate=0.2))
    with pytest.warns(UserWarning, match="metadata mismatch"):
        assert not ckpt.check_metadata(ckpt.create_checkpoint_manager(tmp_path, drifted), drifted)


# --- metrics and evaluation ---------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_detailed_event_loss_matches_jax(seed):
    from tests.test_ops import _make_probs

    from audio_to_midi_tpu_torch.ops.eventize import extract_events
    from audio_to_midi_tpu_torch.ops.rasterize import rasterize_events_np

    probs = _make_probs(seed, 250, 90)
    # The predicted notes two frames late, and 260 frames of them.
    expected = rasterize_events_np([(a + 2, k, d, v) for a, k, d, v in extract_events(probs)],
                                   260)
    ours = pt_metrics.detailed_event_loss(probs, expected)
    ref = jax_metrics.detailed_event_loss(probs, expected)
    for field in ("full_diff", "phantom_notes_diff", "missed_notes_diff", "hit_rate"):
        assert getattr(ours, field) == pytest.approx(getattr(ref, field), rel=1e-5), field
    assert ours.notes_hit == ref.notes_hit > 0


def test_testset_loss_matches_jax(dataset):
    cfg = port_cfg()
    params, _ = jax_model.init(jax.random.PRNGKey(3), JAX_CFG.model)
    model = _model_from(flatten_tree(jax.tree.map(np.asarray, params)), cfg)
    rope = pt_model.make_rope(cfg.model)
    ours = pt_evaluate.compute_testset_loss_individual(model, cfg, dataset, FRAMES, rope)
    ref = jax_evaluate.compute_testset_loss_individual(
        params, JAX_CFG, dataset, FRAMES, jax_model.make_rope(JAX_CFG.model), ensemble=False,
        generate_visualizations=False)
    assert sorted(ours) == sorted(ref)
    for name in ours:
        for key in ("loss", "hit_rate", "eventized_diff", "phantom_note_diff",
                    "missed_note_diff"):
            np.testing.assert_allclose(ours[name][key], ref[name][key], rtol=1e-5, err_msg=key)
        # Fewer than 30 samples: a figure per sample by default, as in JAX.
        assert len(ours[name]["visualizations"]) == 1
    loss, hit, eventized, figs = pt_evaluate.compute_testset_loss(model, cfg, dataset, FRAMES,
                                                                 rope)
    assert loss.shape == hit.shape == eventized.shape == (1,) and len(figs) == len(ours)
    assert 0.0 <= hit[0] <= 1.0


def test_configure_tensorboard_names_the_flag_without_tensorboard(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="--no-tensorboard"):
        pt_metrics.configure_tensorboard()


# --- the CLIs ---------------------------------------------------------------------


def test_train_cli_checkpoints_resumes_and_serves(dataset, tmp_path, caplog):
    from audio_to_midi_tpu_torch.cli import audio_to_midi, train_cli

    cfg = port_cfg()
    cfg = dataclasses.replace(
        cfg, transforms=pt_config.TransformSettings(),
        train=dataclasses.replace(cfg.train, checkpoint_every=2, testset_loss_every=2,
                                  input_ring_capacity=16, dataset_num_workers=1))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(pt_config.config_to_json(cfg))
    ck = tmp_path / "ck"
    base = ["--dataset", str(dataset), "--testset", f"val={dataset}", "--config", str(cfg_path),
            "--checkpoint", str(ck), "--no-tensorboard", "--device", "cpu"]
    with caplog.at_level(logging.INFO):
        assert train_cli.main(base + ["--steps", "3"]) == 0
    assert ckpt.CheckpointManager(ck).all_steps() == [2, 3]
    assert "testset val: loss=" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert train_cli.main(base + ["--steps", "4"]) == 0
    assert "Restored checkpoint at step 3" in caplog.text
    assert "step 4/4" in caplog.text and "step 1/4" not in caplog.text
    assert ckpt.CheckpointManager(ck).all_steps() == [2, 3, 4]

    wav = pt_loader.resolve_audio_file(dataset / "sample_000")
    out = tmp_path / "out.mid"
    assert audio_to_midi.main([str(wav), str(out), "--checkpoint", str(ck), "--config",
                               str(cfg_path), "--device", "cpu", "--overlap", "0.1"]) == 0
    read_midi_file(out)

    # The multi-host flags train over several processes
    # (tests/test_torch_parallel.py); --num-processes without the other two
    # raises by name, as one process with --num-processes 1 is a no-op.
    with pytest.raises(ValueError, match="--coordinator-address and --process-id"):
        train_cli.main(base + ["--num-processes", "2"])
    with pytest.raises(ValueError, match="--coordinator-address and --process-id"):
        train_cli.main(base + ["--num-processes", "2", "--coordinator-address", "localhost:1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_cli.main(base[:-2])
