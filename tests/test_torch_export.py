"""tools/export_params_npz.py: a JAX orbax checkpoint -> the flat .npz the
PyTorch port loads, values bit for bit."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.train import checkpoint as ckpt
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch import infer as pt_infer
from tests.test_torch_primitives import SMALL_CFG, SMALL_JAX_CFG

torch.set_num_threads(2)

TOOL = Path(__file__).resolve().parents[1] / "tools" / "export_params_npz.py"


def _tool():
    spec = importlib.util.spec_from_file_location("export_params_npz", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_export_params_npz_round_trips_a_checkpoint(tmp_path):
    cfg = jax_config.Config(model=SMALL_JAX_CFG)
    params, state = jax_model.init_ensemble(jax.random.PRNGKey(4), cfg.model, 1)
    manager = ckpt.create_checkpoint_manager(tmp_path / "ckpt", cfg, save_interval_steps=1)
    ckpt.save_checkpoint(manager, 3, params, state, force=True)
    manager.wait_until_finished()
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(jax_config.config_to_json(cfg))

    out = tmp_path / "params.npz"
    assert _tool().main(["--checkpoint", str(tmp_path / "ckpt"), "--out", str(out),
                         "--config", str(cfg_path)]) == 0

    expected = convert.flatten_tree(jax.device_get(jax.tree.map(lambda x: x[0], params)))
    flat = convert.load_npz(out)
    assert sorted(flat) == sorted(expected)
    for key, value in expected.items():
        np.testing.assert_array_equal(flat[key], value, err_msg=key)
    model = pt_infer.load_params(out, SMALL_CFG, "cpu")
    q_up = model.transformer.layers[0].get_submodule("local").attention.q_up.w
    np.testing.assert_array_equal(q_up.detach().numpy(),
                                  expected["transformer/local/attention/q_up/w"][0])
