"""The port's remaining single-card CLIs against the JAX package's, on the
same weights and the same synthetic labelled directory: ``audio_to_midi
--validation [--individual]`` and ``infer_cli`` (their printed numbers
within relative 1e-5), ``copy_weights.copy_matching_leaves`` (the same
merged leaves and counts) and ``inspect_model`` (the same lines); and
``train_cli`` with a population, the init surgery and f16."""

import dataclasses
import functools
import logging
import re

import jax
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu.cli import copy_weights as jax_copy_weights
from audio_to_midi_tpu.cli import inspect_model as jax_inspect_model
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.train import checkpoint as jax_ckpt
from audio_to_midi_tpu_torch import config as pt_config
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch import infer as pt_infer
from audio_to_midi_tpu_torch.cli import copy_weights, infer_cli, inspect_model, train_cli
from audio_to_midi_tpu_torch.cli import audio_to_midi as pt_cli
from audio_to_midi_tpu_torch.data import loader as pt_loader
from audio_to_midi_tpu_torch.data import synthetic
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.ops.midi_io import read_midi_file
from audio_to_midi_tpu_torch.train import checkpoint as ckpt
from tests.test_torch_train_loop import JAX_CFG, port_cfg

torch.set_num_threads(2)

NUMBER = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?")


def numbers(text: str) -> list[float]:
    return [float(x) for x in NUMBER.findall(text)]


@functools.lru_cache(maxsize=None)
def _jax_init(model_cfg, size: int):
    return jax.jit(lambda key: jax_model.init_ensemble(key, model_cfg, size)[0])


def jax_params(seed: int, model_cfg, size: int = 1):
    """JAX's init_ensemble, jitted, as a numpy tree with leaves (E, ...)."""
    return jax.tree.map(np.array, _jax_init(model_cfg, size)(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A labelled directory, the config file, and the same weights as a JAX
    checkpoint and as a port checkpoint (step 1 of each)."""
    root = tmp_path_factory.mktemp("cli_tools")
    data = root / "val"
    synthetic.make_synthetic_dataset(data, num_samples=2, duration_s=0.8, notes_per_sample=3,
                                     seed=9)
    cfg_path = root / "config.json"
    # JAX's reader needs a transforms section; validation does not use it.
    cfg_path.write_text(jax_config.config_to_json(
        dataclasses.replace(JAX_CFG, transforms=jax_config.TransformSettings())))
    params = jax_params(3, JAX_CFG.model)
    manager = jax_ckpt.create_checkpoint_manager(root / "jax_ck", JAX_CFG)
    jax_ckpt.save_checkpoint(manager, 1, params, {}, force=True)
    manager.wait_until_finished()
    cfg = port_cfg()
    model = pt_model.Model(cfg.model)
    model.load_state_dict(convert.jax_to_state_dict(
        convert.flatten_tree(jax.tree.map(lambda x: x[0], params))))
    ckpt.save_checkpoint(ckpt.create_checkpoint_manager(root / "pt_ck", cfg), 1, model, {},
                         force=True)
    return root, data, cfg_path


def run(main, argv, capsys) -> tuple[int, str]:
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("individual", [False, True])
def test_audio_to_midi_validation_matches_jax(env, capsys, individual):
    from audio_to_midi_tpu.cli import audio_to_midi as jax_cli

    root, data, cfg_path = env
    extra = ["--individual"] if individual else []
    rc, ref = run(jax_cli.main, [str(data), "--validation", "--checkpoint", str(root / "jax_ck"),
                                 "--config", str(cfg_path)] + extra, capsys)
    assert rc == 0
    rc, ours = run(pt_cli.main, [str(data), "--validation", "--checkpoint", str(root / "pt_ck"),
                                 "--config", str(cfg_path), "--device", "cpu"] + extra, capsys)
    assert rc == 0
    ref_lines, our_lines = ref.strip().splitlines(), ours.strip().splitlines()
    assert len(our_lines) == len(ref_lines) == (2 if individual else 3)
    for mine, theirs in zip(our_lines, ref_lines):
        # The same labels (sample names, "Hit rate:") and numbers within 1e-5.
        assert NUMBER.sub("#", mine).replace("#]", "]") == NUMBER.sub("#", theirs).replace(
            "#]", "]")
        np.testing.assert_allclose(numbers(mine), numbers(theirs), rtol=1e-5)


def test_infer_cli_validation_matches_jax_and_writes_midi(env, capsys, tmp_path):
    from audio_to_midi_tpu.cli import infer_cli as jax_infer_cli

    root, data, cfg_path = env
    rc, ref = run(jax_infer_cli.main, [str(data), "--validation", "--checkpoint",
                                       str(root / "jax_ck"), "--config", str(cfg_path)], capsys)
    assert rc == 0 and ref.startswith("Average loss: ")
    common = ["--checkpoint", str(root / "pt_ck"), "--config", str(cfg_path), "--device", "cpu"]
    rc, ours = run(infer_cli.main, [str(data), "--validation"] + common, capsys)
    assert rc == 0 and ours.startswith("Average loss: ")
    np.testing.assert_allclose(numbers(ours), numbers(ref), rtol=1e-5)

    wav = pt_loader.resolve_audio_file(data / "sample_000")
    mid = tmp_path / "out.mid"
    # The test geometry's windows are 0.5 s: the config's 0.5 s overlap
    # would leave no step.
    rc, out = run(infer_cli.main, [str(wav), "--midi", str(mid), "--overlap", "0.1"] + common,
                  capsys)
    assert rc == 0 and f"Wrote {mid}" in out
    frames = int(re.search(r"Frame count: (\d+)", out).group(1))
    assert frames > 0
    read_midi_file(mid)
    # --plot draws the stitched probabilities (and shows them: Agg returns).
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.close("all")
    rc, out = run(infer_cli.main, [str(wav), "--plot", "--overlap", "0.1"] + common, capsys)
    assert rc == 0 and f"Frame count: {frames}" in out
    (fig,) = [plt.figure(n) for n in plt.get_fignums()]
    assert fig.axes[0].get_title() == "Probs Inferred probs"
    assert fig.axes[0].collections[0].get_array().size == frames * 90
    plt.close("all")


def test_audio_to_midi_needs_an_output_without_validation(env, capsys):
    root, data, cfg_path = env
    wav = pt_loader.resolve_audio_file(data / "sample_000")
    with pytest.raises(SystemExit):
        pt_cli.main([str(wav), "--checkpoint", str(root / "pt_ck"), "--device", "cpu"])
    assert "required without --validation" in capsys.readouterr().err
    assert pt_cli.build_parser().parse_args([str(data)]).checkpoint is None


DEEPER = dataclasses.replace(JAX_CFG.model, depths=(2, 1), num_transformer_layers=2)


@pytest.mark.parametrize("new_model", [JAX_CFG.model, DEEPER], ids=["same", "deeper"])
def test_copy_matching_leaves_matches_jax(new_model):
    old = jax.tree.map(lambda x: x[0], jax_params(1, JAX_CFG.model))
    new = jax.tree.map(lambda x: x[0], jax_params(2, new_model))
    ref, ref_copied, ref_fresh = jax_copy_weights.copy_matching_leaves(old, new)
    ours, copied, fresh = copy_weights.copy_matching_leaves(convert.flatten_tree(old),
                                                            convert.flatten_tree(new))
    ref = convert.flatten_tree(ref)
    assert (copied, fresh) == (ref_copied, ref_fresh)
    assert ours.keys() == ref.keys()
    for path in ref:
        np.testing.assert_array_equal(ours[path], ref[path], err_msg=path)
    if new_model is DEEPER:
        assert 0 < fresh < len(ref)
    else:
        assert fresh == 0


def test_copy_weights_cli_migrates_a_checkpoint(env, capsys, tmp_path):
    root, _, cfg_path = env
    rc, out = run(copy_weights.main, [str(root / "pt_ck"), str(tmp_path / "dest"),
                                      "--config", str(cfg_path)], capsys)
    assert rc == 0
    count = len(convert.load_npz(root / "pt_ck" / "1" / "params.npz"))
    assert f"Copied {count} leaves, kept 0 freshly-initialized leaves" in out
    merged, step = ckpt.restore_raw(tmp_path / "dest")
    source, _ = ckpt.restore_raw(root / "pt_ck")
    assert step == 0 and all(np.array_equal(merged[k], source[k]) for k in source)
    assert ckpt.CheckpointManager(tmp_path / "dest").metadata() == JAX_CFG.metadata()
    # Into a population of 2: every leaf gains the axis, nothing matches.
    rc, out = run(copy_weights.main, [str(root / "pt_ck"), str(tmp_path / "pop"), "--config",
                                      str(cfg_path), "--ensemble-size", "2"], capsys)
    assert rc == 0 and f"Copied 0 leaves, kept {count}" in out
    assert all(v.shape[0] == 2 for v in ckpt.restore_raw(tmp_path / "pop")[0].values())


def test_inspect_model_lines_match_jax(env, capsys, tmp_path):
    params = jax.tree.map(lambda x: x[0], jax_params(4, JAX_CFG.model))
    flat = convert.flatten_tree(params)
    for poisoned in (False, True):
        if poisoned:
            flat["decoder/out/b"][3] = np.nan
            params["decoder"]["out"]["b"][3] = np.nan
        ref, ours = [], []
        assert jax_inspect_model.inspect_params(params, out=ref.append) == (not poisoned)
        assert inspect_model.inspect_params(flat, out=ours.append) == (not poisoned)
        assert ours == ref
    assert any("WARNING: 1 non-finite values!" in line for line in ours)

    root, _, _ = env
    rc, out = run(inspect_model.main, [str(root / "pt_ck"), "--no-histograms"], capsys)
    assert rc == 0 and out.startswith("Inspecting checkpoint at step 1")
    manager = ckpt.CheckpointManager(tmp_path / "bad")
    manager.save(2, flat, {})
    rc, out = run(inspect_model.main, [str(tmp_path / "bad")], capsys)
    assert rc == 1 and "WARNING: model contains non-finite weights" in out


# --- train_cli: a population with the init surgery, and f16 ---------------------------


def test_train_cli_trains_evolves_and_resumes_a_population(env, tmp_path, caplog):
    root, data, _ = env
    cfg = port_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_every=2, testset_loss_every=2, print_every=1,
        use_custom_init=True, dataset_num_workers=1))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(pt_config.config_to_json(cfg))
    ck = tmp_path / "ck"
    base = ["--dataset", str(data), "--testset", f"val={data}", "--config", str(cfg_path),
            "--checkpoint", str(ck), "--no-tensorboard", "--device", "cpu",
            "--ensemble-size", "4"]
    with caplog.at_level(logging.INFO):
        assert train_cli.main(base + ["--steps", "2"]) == 0
    assert "step 2: evolved the population" in caplog.text
    flat, step = ckpt.restore_raw(ck)
    assert step == 2 and all(v.shape[0] == 4 for v in flat.values())
    # The surgery's N(0, 0.2) conv weights, not the uniform init's bound.
    assert abs(flat["cnn/stages/1/blocks/pw1/w"].std() - 0.2) < 0.06
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert train_cli.main(base + ["--steps", "3"]) == 0
    assert "Restored checkpoint at step 2" in caplog.text and "step 3/3" in caplog.text
    assert ckpt.CheckpointManager(ck).all_steps() == [2, 3]
    member, _ = pt_infer.load_newest_checkpoint(
        ck, cfg, "cpu", ensemble_size=4, ensemble_select=3)
    assert isinstance(member, pt_model.Model)
    trio = [str(tmp_path / "ck3") if a == str(ck) else a for a in base[:-1]] + ["3"]
    with pytest.raises(ValueError, match="ensemble_size 3 cannot evolve"):
        train_cli.main(trio + ["--steps", "1"])


def test_train_cli_trains_in_f16_with_loss_scaling(env, tmp_path, monkeypatch):
    # The threaded loader's batches: whole windows only.  The grain
    # pipeline pads this set's 4 windows to the batch of 8 with zeros, on
    # which a step overflows f16 and rolls back (not a clean step).
    from audio_to_midi_tpu_torch.train import loop

    _, data, _ = env
    cfg = port_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, print_every=1, dataset_num_workers=1, loss_scale_increase_threshold=1e9))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(pt_config.config_to_json(cfg))
    hooks = []
    real = loop.train
    monkeypatch.setattr(loop, "train", lambda *args, **kwargs: real(
        *args, step_hook=lambda step, info: hooks.append((step, info)), **kwargs))
    assert train_cli.main(["--dataset", str(data), "--config", str(cfg_path), "--checkpoint",
                           str(tmp_path / "ck"), "--no-tensorboard", "--device", "cpu",
                           "--precision", "f16", "--steps", "3", "--threaded-loader"]) == 0
    assert [s for s, _ in hooks] == [1, 2, 3]
    assert all(np.isfinite(info["loss"]).all() for _, info in hooks)
    # Clean steps below the threshold double the scale: 2, 4, 8.
    assert [info["grad_scale"] for _, info in hooks] == [2.0, 4.0, 8.0]
