"""The port's init surgery against the JAX package's
(``train/init_surgery.py``): fed JAX's own normal draws, leaf for leaf in
``jax.tree.leaves`` order, it gives JAX's parameters bit for bit; with the
port's generator, the targets and standard deviations of JAX's
tests/test_init_surgery.py, and a finite forward afterwards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.train.init_surgery import apply_init_surgery as jax_surgery
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.train import init_surgery as pt_surgery
from tests.test_torch_primitives import port_config

torch.set_num_threads(2)

# JAX's tests/test_init_surgery.py CFG: stacked blocks and two layer pairs.
CFG = jax_config.ModelConfig(
    dims=(8, 16, 32), depths=(2, 2, 2), num_transformer_layers=2, num_transformer_heads=2,
    attention_size=16, compressed_attention_kv_size=16, compressed_attention_q_size=16,
    rope_max_positions=64)
PORT_CFG = port_config(jax_config.Config(model=CFG))


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jax.jit(lambda key: jax_model.init(key, CFG)[0])(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("seed", [7, 8])
def test_surgery_on_jaxs_draws_is_jaxs_bit_for_bit(params, seed):
    key = jax.random.PRNGKey(seed)
    ref = convert.flatten_tree(jax.device_get(jax_surgery(params, key,
                                                          CFG.num_transformer_heads)))
    flat = convert.flatten_tree(params)
    keys = jax.random.split(key, len(flat))
    drawn = []

    def normal(index, shape):
        drawn.append(index)
        return np.asarray(jax.random.normal(keys[index], shape, jnp.float32))

    ours = pt_surgery.apply_init_surgery(flat, CFG.num_transformer_heads, normal)
    assert ours.keys() == ref.keys()
    for path in ref:
        np.testing.assert_array_equal(ours[path], ref[path], err_msg=path)
    order = convert.jax_leaf_order(flat)
    targets = [order[i] for i in drawn]
    assert all(p.endswith(("/q_up/w", "/kv_down/w", "/k_up/w", "/v_up/w", "/conv/w",
                           "/conv/b", "/depth_conv/w", "/depth_conv/b", "/pw1/w", "/pw1/b",
                           "/pw2/w", "/pw2/b")) for p in targets)
    changed = [p for p in ref if not np.array_equal(ref[p], flat[p])]
    assert sorted(changed) == sorted(targets)


def test_surgery_targets_and_distributions(params):
    model = pt_model.Model(PORT_CFG.model)
    model.load_state_dict(convert.jax_to_state_dict(convert.flatten_tree(params)))
    bound = list(model.parameters())
    pt_surgery.apply_init_surgery_(model, CFG.num_transformer_heads,
                                   torch.Generator().manual_seed(7))
    assert all(a is b for a, b in zip(bound, model.parameters()))  # in place
    old = convert.flatten_tree(params)
    out = convert.state_dict_to_jax(model.state_dict())

    # Attention projections re-drawn ~N(0, 0.2); the out-projection untouched.
    for side in ("local", "global"):
        prefix = f"transformer/{side}/attention"
        for name in ("q_up", "kv_down", "k_up", "v_up"):
            w = out[f"{prefix}/{name}/w"]
            for layer in range(CFG.num_transformer_layers):
                assert not np.allclose(w[layer], old[f"{prefix}/{name}/w"][layer])
                assert abs(w[layer].std() - 0.2) < 0.05, (name, w[layer].std())
        np.testing.assert_array_equal(out[f"{prefix}/out/w"], old[f"{prefix}/out/w"])

    # Conv weights ~N(0, 0.2), biases ~N(0, 0.01).
    for i in range(len(CFG.dims)):
        w = out[f"cnn/stages/{i}/down/conv/w"]
        assert abs(w.std() - 0.2) < 0.06, (i, w.std())
        assert out[f"cnn/stages/{i}/down/conv/b"].std() < 0.05
        for name in ("depth_conv", "pw1", "pw2"):
            bw = out[f"cnn/stages/{i}/blocks/{name}/w"]
            assert abs(bw.std() - 0.2) < 0.06, (i, name, bw.std())

    # Untouched: LayerNorms, gamma, the feed-forward, the decoder.
    untouched = [p for p in old if p.split("/")[-2] not in
                 ("q_up", "kv_down", "k_up", "v_up", "conv", "depth_conv", "pw1", "pw2")]
    assert any(p.startswith("decoder/") for p in untouched)
    assert any("/ff/" in p for p in untouched)
    for path in untouched:
        np.testing.assert_array_equal(out[path], old[path], err_msg=path)


def test_surgery_follows_its_generator_and_the_forward_still_works(params):
    models = []
    for seed in (2, 2, 3):
        model = pt_model.Model(PORT_CFG.model)
        model.load_state_dict(convert.jax_to_state_dict(convert.flatten_tree(params)))
        models.append(pt_surgery.apply_init_surgery_(model, CFG.num_transformer_heads,
                                                     torch.Generator().manual_seed(seed)))
    same = [torch.equal(a, b) for a, b in zip(models[0].parameters(), models[1].parameters())]
    other = [torch.equal(a, b) for a, b in zip(models[0].parameters(), models[2].parameters())]
    assert all(same) and not all(other)
    audio = torch.randn((1, 2, 1000), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        logits, probs = pt_model.forward(models[0], PORT_CFG.model, audio,
                                         pt_model.make_rope(PORT_CFG.model))
    assert torch.isfinite(logits).all()
    assert probs.shape == (1, CFG.output_frames(1000), 90)
