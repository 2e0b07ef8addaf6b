"""The port's optimizer (schedule, layer-wise factors, the update chain) vs
the JAX package's optax chain.

Same parameters on both sides (JAX ``models/model.init`` through the
converter) and the same seeded numpy gradients.  Tolerance (f32, CPU):
updates rtol 1e-3 with an atol of 1e-9 -- an update is at most lr * factor
in size and the two chains differ only in the order of their sums (the
global norm) and in ``u * (clip / norm)`` against ``(u / norm) * clip``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.train import optim as jax_optim
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.train import optim as pt_optim
from tests.test_torch_primitives import port_config, rand
from tests.test_torch_train import (  # noqa: F401  (tree is a fixture)
    JAX_MODEL_CFG, assert_trees_close, fresh_model, jax_cfg, tree,
)

torch.set_num_threads(2)


def test_lr_decay_factors_match_the_jax_tree():
    mcfg = dataclasses.replace(JAX_MODEL_CFG, dims=(4, 8, 8), depths=(1, 2, 1))
    cfg = port_config(jax_config.Config(model=mcfg))
    params, _ = jax_model.init(jax.random.PRNGKey(0), mcfg)
    factors = jax_optim.lr_decay_factors(params, mcfg, 0.7)
    full = jax.tree.map(lambda p, f: np.broadcast_to(np.asarray(f, np.float32), p.shape),
                        params, factors)
    ref = convert.jax_to_state_dict(convert.flatten_tree(full))
    names = list(ref)
    mine = pt_optim.lr_decay_factors(names, cfg.model, 0.7)
    assert pt_optim.max_conv_depth(cfg.model) == jax_optim.max_conv_depth(mcfg) == 4
    for name, factor in zip(names, mine):
        np.testing.assert_allclose(ref[name].numpy(), factor, rtol=1e-6, err_msg=name)
    by_name = dict(zip(names, mine))
    assert by_name["cnn.stages.0.down.conv.w"] == pytest.approx(0.7 ** 4)
    assert by_name["cnn.stages.1.blocks.1.pw1.w"] == pytest.approx(0.7 ** (4 - 3))
    assert by_name["cnn.final_norm.scale"] == by_name["decoder.out.w"] == 1.0


@pytest.mark.parametrize("warmup,num_steps", [(10, 50), (0, 50), (1000, 200_000)])
def test_learning_rate_schedule_matches_optax(warmup, num_steps):
    schedule = jax_optim.create_learning_rate_schedule(1e-4, warmup, num_steps)
    for count in {0, 1, max(warmup - 1, 0), warmup, warmup + 1, num_steps, warmup + num_steps,
                  warmup + num_steps + 5}:
        mine = pt_optim.learning_rate(count, 1e-4, warmup, num_steps)
        np.testing.assert_allclose(mine, float(schedule(count)), rtol=1e-5, atol=1e-12,
                                   err_msg=str(count))
    if warmup:
        assert pt_optim.learning_rate(0, 1e-4, warmup, num_steps) == 0.0


# base rate 1e-4: the update norm stays under the clip; 1e-2: ~0.01 per
# element over ~27 000 parameters exceeds 1.0, so the clip -- last in the
# chain, after the layer-wise factors -- is what is tested.
@pytest.mark.parametrize("base_lr,clipped", [(1e-4, False), (1e-2, True)])
def test_two_updates_match_the_optax_chain(tree, base_lr, clipped):
    jcfg = jax_cfg(warmup_steps=0, base_learning_rate=base_lr, num_steps=100)
    cfg = port_config(jcfg)
    model = fresh_model(tree, cfg)
    tx, _ = jax_optim.setup_optimizers(tree, JAX_MODEL_CFG, jcfg.train)
    opt_state = tx.init(tree)
    tx_update = jax.jit(tx.update)
    opt = pt_optim.setup_optimizers(model, cfg.model, cfg.train)
    rng = np.random.default_rng(5)
    params = tree
    for count in range(2):
        grads = {n: rand(rng, *p.shape) * 0.3 for n, p in model.named_parameters()}
        jgrads = jax.tree.unflatten(
            jax.tree.structure(tree),
            [jnp.asarray(convert.state_dict_to_jax(
                {n: torch.from_numpy(g) for n, g in grads.items()})[path])
             for path in convert.flatten_tree(jax.device_get(tree))])
        ref_updates, opt_state = tx_update(jgrads, opt_state, params)
        updates = opt.update([torch.from_numpy(grads[n]) for n in opt.names])
        assert opt.count == count + 1
        mine = convert.state_dict_to_jax(dict(zip(opt.names, updates)))
        assert any(np.abs(u).max() > 0 for u in mine.values())  # not all zero
        norm = float(np.sqrt(sum(np.square(u, dtype=np.float64).sum() for u in mine.values())))
        assert (abs(norm - 1.0) < 1e-4) if clipped else (norm < 0.5)
        assert_trees_close(mine, ref_updates, rtol=1e-3, atol_of_scale=1e-9)
        params = optax.apply_updates(params, ref_updates)
        opt.apply(updates)
    assert_trees_close(convert.state_dict_to_jax(model.state_dict()), params,
                       rtol=1e-5, atol_of_scale=1e-6)


def test_the_first_update_under_a_warmup_is_zero(tree):
    cfg = port_config(jax_cfg(warmup_steps=10))
    model = fresh_model(tree, cfg)
    opt = pt_optim.setup_optimizers(model, cfg.model, cfg.train)
    updates = opt.update([torch.ones_like(p) for p in opt.params])
    assert all(not u.any() for u in updates) and opt.count == 1
    assert opt.learning_rate() == pytest.approx(1e-4 / 10)


def test_the_optimizer_refuses_parameters_that_are_not_f32(tree):
    cfg = port_config(jax_cfg())
    model = fresh_model(tree, cfg).bfloat16()
    with pytest.raises(ValueError, match="f32"):
        pt_optim.setup_optimizers(model, cfg.model, cfg.train)
