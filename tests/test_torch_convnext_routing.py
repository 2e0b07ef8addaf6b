"""The routing of the port's ``cnn_forward`` through the ConvNeXt stage
kernels, against the JAX package's, and one training step through the stage
backward.

Tolerances: ``assert_leaf_close`` of tests/test_torch_convnext_kernels.py
(bf16 within 2 ulps of a leaf's top binade, f32 within 1e-5 of its largest
magnitude) wherever both sides run the same kernels on the same rows: in f32
the whole encoder.  In bf16 the encoder's narrow first stage rounds elsewhere
on the JAX side (its packed rewrite), and the limit is the JAX package's own
3 % of a leaf's largest.  The training step: as tests/test_torch_train.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu.models import convnext as jax_convnext
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.ops import pallas_convnext as jax_stage_fwd
from audio_to_midi_tpu.ops import pallas_convnext_bwd as jax_stage_bwd
from audio_to_midi_tpu.ops.pallas_attention import mosaic_dtype_ok
from audio_to_midi_tpu.train import optim as jax_optim
from audio_to_midi_tpu.train import step as jax_step
from audio_to_midi_tpu_torch import config as pt_config
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.models import convnext as pt_convnext
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.ops import convnext_kernels as ck
from audio_to_midi_tpu_torch.train import optim as pt_optim
from audio_to_midi_tpu_torch.train import step as pt_step
from tests.test_torch_convnext_kernels import DTYPES, as_np, assert_leaf_close, to_torch
from tests.test_torch_primitives import port_config, port_model, rand

torch.set_num_threads(2)


def small_cfg(**kw) -> jax_config.ModelConfig:
    """The JAX routing test's encoder: a packed 4-wide stage, then 128 wide."""
    return dataclasses.replace(jax_config.Config().model, dims=(4, 128), depths=(1, 2),
                               cnn_scan_unroll=1, **kw)


def port_model_cfg(jcfg: jax_config.ModelConfig) -> pt_config.ModelConfig:
    return port_config(jax_config.Config(model=jcfg)).model


def cnn_value_and_grads(cfg: pt_config.ModelConfig, cnn, x: np.ndarray, cot: np.ndarray, dtype):
    out = pt_convnext.cnn_forward(to_torch(x, dtype), cnn, cfg)  # parameters cast at use
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in cnn.named_parameters()}


@pytest.mark.parametrize("name", ["bf16", "f32"])
def test_cnn_forward_routes_and_matches_jax(name):
    tdt, jdt = DTYPES[name]
    cfg_on = small_cfg(cnn_bwd_kernel=True)
    params = jax_convnext.init_cnn(jax.random.PRNGKey(0), cfg_on)
    # Gamma O(1) in the 128-wide stage, so its branch carries gradient.
    params["stages"][1]["blocks"]["gamma"] = jnp.asarray(
        np.random.default_rng(13).uniform(0.5, 1.5, (2, 128)).astype(np.float32))
    rng = np.random.default_rng(14)
    # A random cotangent: the plain sum of the final LayerNorm's output has
    # no gradient to speak of.
    x, cot = rand(rng, 1, 160, 2), rand(rng, 1, 16, 128)

    def jax_run(cfg):
        cast = jax.tree.map(lambda a: a.astype(jdt), params)
        f = lambda p: jnp.sum(jax_convnext.cnn_forward(jnp.asarray(x).astype(jdt), p, cfg)
                              .astype(jnp.float32) * jnp.asarray(cot))
        return jax.value_and_grad(f)(cast)

    flat = {"cnn/" + k: v for k, v in convert.flatten_tree(jax.device_get(params)).items()}
    state = {k[len("cnn."):]: v for k, v in convert.jax_to_state_dict(flat).items()}
    results = {}
    for label, kw in (("on", dict(cnn_bwd_kernel=True)), ("off", dict(cnn_bwd_kernel=False)),
                      ("stage", dict(cnn_impl="pallas_stage"))):
        cfg = port_model_cfg(small_cfg(**kw))
        cnn = pt_convnext.CNN(cfg)
        cnn.load_state_dict(state, strict=True)
        assert [pt_convnext.stage_route(cfg, i, n, tdt) for i, n in enumerate((32, 16))] == \
            ["blocks", {"on": "stage_bwd", "off": "blocks", "stage": "stage_fwd"}[label]]
        results[label] = cnn_value_and_grads(cfg, cnn, x, cot, tdt)
    # The flag changes the backward only: the value is the block loop's.
    assert torch.equal(results["on"][0], results["off"][0])
    assert_leaf_close(results["stage"][0], results["off"][0], name, "pallas_stage value")
    # Against jax.grad of the JAX encoder.  f32: every leaf, both routes.  bf16:
    # the kernel-20 route, on the leaves the stage's backward produces, within
    # the JAX package's own 3 % of the leaf's largest -- the stage's input
    # comes from the JAX side's packed rewrite of the 4-wide stage, which
    # rounds elsewhere, so the two sides do not see the same bf16 rows.
    for label in ("on", "stage") if name == "f32" else ("on",):
        _, ref_grads = jax_run(small_cfg(**(dict(cnn_impl="pallas_stage") if label == "stage"
                                            else dict(cnn_bwd_kernel=True))))
        ref = convert.flatten_tree(jax.tree.map(as_np, ref_grads))
        mine = convert.state_dict_to_jax({"cnn." + n: g for n, g in results[label][1].items()})
        for path, r in ref.items():
            if name == "f32":
                assert_leaf_close(mine["cnn/" + path], r, name, f"{label} {path}")
            elif path.startswith("stages/1/blocks"):
                err = np.abs(as_np(mine["cnn/" + path]) - r).max() / max(np.abs(r).max(), 1e-3)
                assert err < 0.03, (label, path, err)


def test_default_config_routes_as_the_jax_gates_do():
    default = pt_config.ModelConfig()
    staged = dataclasses.replace(default, cnn_impl="pallas_stage")
    lengths = [80_000 // 5 // 2 ** i for i in range(7)]
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                     (torch.float16, jnp.float16)):
        bwd = [jax_stage_bwd.bwd_stage_supported(n, c, h, jdt)
               for n, c, h in zip(lengths, default.dims, default.cnn_hidden_dims)]
        fwd = [mosaic_dtype_ok(jdt) and jax_stage_fwd.stage_supported(n, c, d)
               for n, c, d in zip(lengths, default.dims, default.depths)]
        routes = [pt_convnext.stage_route(default, i, n, tdt) for i, n in enumerate(lengths)]
        assert routes == ["stage_bwd" if b else "blocks" for b in bwd]
        routes = [pt_convnext.stage_route(staged, i, n, tdt) for i, n in enumerate(lengths)]
        assert routes == ["stage_fwd" if f else "stage_bwd" if b else "blocks"
                          for f, b in zip(fwd, bwd)]
        if tdt == torch.float16:
            assert not any(bwd) and not any(fwd)
        else:
            assert bwd == [False] * 5 + [True, True] and fwd == [False] * 4 + [True] * 3
    # Stochastic depth takes the block loop, as does cnn_impl="xla".
    assert pt_convnext.stage_route(default, 5, 500, torch.bfloat16, enable_sdd=True) == "blocks"
    xla = dataclasses.replace(default, cnn_impl="xla")
    assert all(pt_convnext.stage_route(xla, i, n, torch.bfloat16) == "blocks"
               for i, n in enumerate(lengths))


def test_gates_take_at_least_what_the_jax_gates_take():
    for c in range(64, 1025, 64):
        for hidden in (128, 256, 384, 512, 1024):
            for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
                if jax_stage_bwd.bwd_stage_supported(500, c, hidden, jdt):
                    assert ck.stage_bwd_supported(500, c, hidden, 3, tdt), (c, hidden)
                if jax_stage_fwd.stage_supported(500, c, 3):
                    assert ck.stage_fwd_supported(500, c, 3, tdt), c
    assert not ck.stage_bwd_supported(500, 128, 256, 3, torch.float16)
    assert not ck.stage_bwd_supported(500, 128, 256, 0, torch.bfloat16)
    assert not ck.stage_fwd_supported(4, 128, 3, torch.bfloat16)
    assert not ck.stage_fwd_supported(500, 32, 3, torch.bfloat16)


def test_stochastic_depth_takes_the_block_loop(monkeypatch):
    cfg = port_model_cfg(small_cfg(enable_cnn_stochastic_depth=True, sdd_rate=0.5))
    cnn = pt_convnext.CNN(cfg, torch.Generator().manual_seed(0))
    x = to_torch(rand(np.random.default_rng(15), 2, 320, 2), torch.float32)

    def refuse(*args):
        raise AssertionError("a stage kernel ran under stochastic depth")

    monkeypatch.setattr(ck, "stage_blocks_fused_bwd", refuse)
    out = pt_convnext.cnn_forward(x, cnn, cfg, generator=torch.Generator().manual_seed(1),
                                  enable_dropout=True)
    assert out.requires_grad and torch.isfinite(out).all()
    with pytest.raises(AssertionError, match="stage kernel"):
        pt_convnext.cnn_forward(x, cnn, cfg)  # without it the 128-wide stage takes kernel 20


# --- one whole training step through kernel 20 --------------------------------

# Six stages that double from 4 to 128 channels (the JAX side packs the four
# narrow ones), so the last stage, 25 rows of 128 channels, takes kernel 20 on
# both sides; one pair of attention layers on the two-phase route.
STEP_MODEL_CFG = jax_config.ModelConfig(
    dims=(4, 8, 16, 32, 64, 128),
    depths=(1, 1, 1, 1, 1, 2),
    num_transformer_layers=1,
    num_transformer_heads=2,
    attention_size=16,
    compressed_attention_q_size=16,
    compressed_attention_kv_size=16,
    transformer_dropout_rate=0.0,
    attention_impl="pallas",
    cnn_impl="pallas",
    cnn_bwd_kernel=True,
)


def test_train_step_through_the_stage_backward_matches_jax(monkeypatch):
    """Loss and every updated parameter of one step, batch 4 = 2 x 2, f32;
    tolerances as tests/test_torch_train.py."""
    jcfg = jax_config.Config(
        model=STEP_MODEL_CFG, precision=jax_config.PrecisionConfig(compute_dtype=jnp.float32),
        train=dataclasses.replace(jax_config.TrainConfig(), warmup_steps=0,
                                  base_learning_rate=1e-2, num_steps=100))
    cfg = port_config(jcfg)
    assert cfg.model.cnn_bwd_kernel and pt_convnext.stage_route(
        cfg.model, 5, 25, torch.float32) == "stage_bwd"
    tree, _ = jax_model.init(jax.random.PRNGKey(0), STEP_MODEL_CFG)
    tree["cnn"]["stages"][5]["blocks"]["gamma"] = jnp.asarray(
        np.random.default_rng(16).uniform(0.5, 1.5, (2, 128)).astype(np.float32))
    model = port_model(convert.flatten_tree(jax.device_get(tree)), cfg).train()
    tx, _ = jax_optim.setup_optimizers(tree, STEP_MODEL_CFG, jcfg.train)
    ref_step = jax_step.make_train_step(jcfg, tx, jax_model.make_rope(STEP_MODEL_CFG),
                                        mesh=None, ensemble=False)
    opt = pt_optim.setup_optimizers(model, cfg.model, cfg.train)
    step = pt_step.make_train_step(cfg, opt, pt_model.make_rope(cfg.model))
    rng = np.random.default_rng(17)
    audio = rand(rng, 2, 2, 2, 4_000) * 0.5
    labels = (rng.random((2, 2, 25, 90)) < 0.05).astype(np.float32)
    params = jax.tree.map(jnp.copy, tree)
    ref = ref_step(params, tx.init(params), jnp.asarray(audio), jnp.asarray(labels),
                   jax.random.PRNGKey(0), jnp.float32(1.0))
    launched, real = [], ck.stage_bwd
    monkeypatch.setattr(ck, "stage_bwd", lambda *a: (launched.append(1), real(*a))[1])
    out = step(model, torch.from_numpy(audio), torch.from_numpy(labels), 1.0)
    assert len(launched) == 2                      # one stage, two minibatches
    assert bool(out.grads_valid) and bool(ref.grads_valid)
    np.testing.assert_allclose(float(out.loss), float(ref.loss), rtol=1e-5)
    mine = convert.state_dict_to_jax(model.state_dict())
    for path, r in convert.flatten_tree(jax.device_get(ref.params)).items():
        atol = 1e-6 * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(mine[path], r, rtol=1e-3, atol=atol, err_msg=path)
