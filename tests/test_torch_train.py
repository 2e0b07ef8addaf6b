"""The port's training slice (loss and step) vs the JAX package; the
optimizer is in tests/test_torch_optim.py.

Same parameters on both sides (JAX ``models/model.init`` through the
converter), same seeded numpy audio and labels, f32 compute, dropout rate
0.0.  The JAX side runs ``attention_impl="pallas"``: its forward and
backward attention kernels in interpret mode, and ``cnn_impl="xla"`` (narrow
widths; that also keeps its ConvNeXt stage-backward kernel out).  The port
runs its wrappers' plain versions and plain backward versions.

Tolerances (f32, CPU).  Gradients: rtol 5e-3 / atol 5e-4 of the gradient's
scale, the JAX package's own for its backward kernels
(tests/test_pallas_bwd.py).  Updates and parameters after two steps: rtol
1e-3 / atol 1e-6 -- an update is at most lr * factor in size and the two
chains differ only in summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.train import loss as jax_loss
from audio_to_midi_tpu.train import optim as jax_optim
from audio_to_midi_tpu.train import step as jax_step
from audio_to_midi_tpu_torch import config as pt_config
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.models import convnext as pt_convnext
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.train import loss as pt_loss
from audio_to_midi_tpu_torch.train import optim as pt_optim
from audio_to_midi_tpu_torch.train import step as pt_step
from tests.test_torch_primitives import close, port_config, port_model, rand

torch.set_num_threads(2)

JAX_MODEL_CFG = jax_config.ModelConfig(
    dims=(4, 8, 8, 16, 16, 32, 32),
    depths=(1, 2, 1, 1, 1, 1, 1),
    num_transformer_layers=1,
    num_transformer_heads=2,
    attention_size=16,
    compressed_attention_q_size=16,
    compressed_attention_kv_size=16,
    transformer_dropout_rate=0.0,
    attention_impl="pallas",
    cnn_impl="xla",
)


def jax_cfg(**train) -> jax_config.Config:
    return jax_config.Config(
        model=JAX_MODEL_CFG,
        precision=jax_config.PrecisionConfig(compute_dtype=jnp.float32),
        train=dataclasses.replace(jax_config.TrainConfig(), **train),
    )


@pytest.fixture(scope="module")
def tree():
    params, _ = jax_model.init(jax.random.PRNGKey(0), JAX_MODEL_CFG)
    return params


def fresh_model(tree, cfg) -> pt_model.Model:
    return port_model(convert.flatten_tree(jax.device_get(tree)), cfg)


def batch(seed: int, lead: tuple[int, ...], num_samples: int):
    """Seeded audio (*lead, 2, N) and sparse 0/1 labels (*lead, F, 90)."""
    rng = np.random.default_rng(seed)
    frames = JAX_MODEL_CFG.output_frames(num_samples)
    audio = rand(rng, *lead, 2, num_samples) * 0.5
    labels = (rng.random((*lead, frames, 90)) < 0.05).astype(np.float32)
    return audio, labels


def flat_grads(model) -> dict[str, np.ndarray]:
    return convert.state_dict_to_jax({n: p.grad for n, p in model.named_parameters()})


def assert_trees_close(mine: dict[str, np.ndarray], ref_tree, rtol, atol_of_scale):
    ref = convert.flatten_tree(jax.device_get(ref_tree))
    assert mine.keys() == ref.keys()
    for path, r in ref.items():
        atol = atol_of_scale * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(mine[path], r, rtol=rtol, atol=atol, err_msg=path)


# --- loss -------------------------------------------------------------------


def test_sigmoid_bce_sum_matches_jax():
    rng = np.random.default_rng(0)
    logits, labels = rand(rng, 3, 7, 90) * 4.0, rng.random((3, 7, 90)).astype(np.float32)
    ref = jax_loss.sigmoid_bce_sum(jnp.asarray(logits), jnp.asarray(labels))
    out = pt_loss.sigmoid_bce_sum(torch.from_numpy(logits), torch.from_numpy(labels))
    assert out.shape == (3,)
    close(out, ref, rtol=1e-5, atol=1e-4)


# 8 000 samples -> 25 frames -> padded 32: the two-phase route (kernels 2 and
# 7 on the JAX side).  16 000 -> 50 frames -> padded 56, 56 % 16 != 0: the
# flattened-window route, kernel 1 and its backward with block=16.
@pytest.mark.parametrize("grad_scale", [1.0, 1024.0])
@pytest.mark.parametrize("num_samples", [8_000, 16_000])
def test_batch_loss_and_gradient_match_jax(tree, num_samples, grad_scale):
    cfg = port_config(jax_cfg())
    audio, labels = batch(num_samples, (2,), num_samples)
    ref_loss, ref_grads = jax.value_and_grad(jax_loss.batch_loss)(
        tree, JAX_MODEL_CFG, jnp.asarray(audio), jnp.asarray(labels),
        jax_model.make_rope(JAX_MODEL_CFG), jnp.float32(grad_scale), jax.random.PRNGKey(1),
        jnp.float32)
    model = fresh_model(tree, cfg)
    loss = pt_loss.batch_loss(model, cfg.model, torch.from_numpy(audio),
                              torch.from_numpy(labels), pt_model.make_rope(cfg.model),
                              grad_scale, torch.float32)
    loss.backward()
    close(loss, ref_loss, rtol=1e-5, atol=0)
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters())
    assert_trees_close(flat_grads(model), ref_grads, rtol=5e-3, atol_of_scale=5e-4)


def test_batch_loss_in_bf16_keeps_f32_parameters_and_gradients(tree):
    cfg = port_config(jax_cfg())
    audio, labels = batch(3, (2,), 8_000)
    model = fresh_model(tree, cfg)
    rope = pt_model.make_rope(cfg.model)
    args = (torch.from_numpy(audio), torch.from_numpy(labels), rope, 1.0)
    ref = pt_loss.batch_loss(model, cfg.model, *args, torch.float32)
    loss = pt_loss.batch_loss(model, cfg.model, *args, torch.bfloat16)
    loss.backward()
    assert loss.dtype == torch.float32
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    close(loss, ref, rtol=2e-2, atol=0)  # bf16 keeps ~3 significant digits per op


# --- what raises until its slice ---------------------------------------------


def test_dropout_above_zero_raises_until_its_kernels_are_ported(tree):
    cfg = port_config(jax_cfg())
    model = fresh_model(tree, cfg)
    audio = torch.zeros(1, 2, 8_000)
    rope = pt_model.make_rope(cfg.model)
    with_dropout = dataclasses.replace(cfg.model, transformer_dropout_rate=0.1)
    # The kernels are ported: a rate above 0 runs, from an explicit generator
    # only (tests/test_torch_train_dropout.py holds it against the JAX model).
    with pytest.raises(ValueError, match="generator"):
        pt_model.forward(model, with_dropout, audio, rope, enable_dropout=True)
    with torch.no_grad():
        _, dropped = pt_model.forward(model, with_dropout, audio, rope, enable_dropout=True,
                                      generator=torch.Generator().manual_seed(0))
        _, free = pt_model.forward(model, with_dropout, audio, rope)
    assert torch.isfinite(dropped).all() and not torch.equal(dropped, free)
    # Rate 0.1 without dropout enabled, and dropout enabled at rate 0.0, are
    # the serving forward.
    with torch.no_grad():
        _, a = pt_model.forward(model, with_dropout, audio, rope)
        _, b = pt_model.forward(model, cfg.model, audio, rope, enable_dropout=True)
    close(a, b, rtol=0, atol=0)


def test_ensemble_raises_until_it_is_ported(tree):
    """The ensemble axis is ported (tests/test_torch_ensemble.py); what
    still raises is a population size that the model or optimizer given
    does not have."""
    cfg = port_config(jax_cfg(ensemble_size=2))
    model = fresh_model(tree, cfg)
    with pytest.raises(ValueError, match="ensemble"):
        pt_optim.setup_optimizers(model, cfg.model, cfg.train)
    one = port_config(jax_cfg())
    opt = pt_optim.setup_optimizers(model, one.model, one.train)
    with pytest.raises(ValueError, match="ensemble"):
        pt_step.make_train_step(cfg, opt, pt_model.make_rope(cfg.model))


def test_stage_backward_kernel_gate_follows_the_jax_gate():
    """The default config sends stages 5 and 6 (128 and 256 channels) to the
    stage-backward kernel, as the JAX gate does; cnn_bwd_kernel=False and f16
    send none; and the default config trains through it."""
    from audio_to_midi_tpu.ops.pallas_convnext_bwd import bwd_stage_supported

    default = pt_config.ModelConfig()
    lengths = [80_000 // 5 // 2 ** i for i in range(7)]
    routes = lambda cfg, dtype: [pt_convnext.stage_route(cfg, i, n, dtype)
                                 for i, n in enumerate(lengths)]
    wanted = [r == "stage_bwd" for r in routes(default, torch.bfloat16)]
    assert wanted == [bwd_stage_supported(n, c, h, jnp.bfloat16)
                      for n, c, h in zip(lengths, default.dims, default.cnn_hidden_dims)]
    assert wanted == [False] * 5 + [True, True]
    assert routes(default, torch.float16) == ["blocks"] * 7
    off = dataclasses.replace(default, cnn_bwd_kernel=False)
    assert routes(off, torch.bfloat16) == ["blocks"] * 7
    # The default config trains: the two wide stages go through the fused
    # backward (its plain version on the CPU), the others through autograd.
    narrow = dataclasses.replace(default, depths=(1,) * 7, num_transformer_layers=1,
                                 transformer_dropout_rate=0.0)
    model = pt_model.Model(narrow, torch.Generator().manual_seed(0))
    before = pt_convnext.convnext_kernels.StageBlocksFusedBwd.apply
    calls = []
    pt_convnext.convnext_kernels.StageBlocksFusedBwd.apply = (
        lambda *a: (calls.append(1), before(*a))[1])
    try:
        logits, _ = pt_model.forward(model, narrow, torch.zeros(1, 2, 8_000),
                                     pt_model.make_rope(narrow), enable_dropout=True)
    finally:
        pt_convnext.convnext_kernels.StageBlocksFusedBwd.apply = before
    assert logits.requires_grad and len(calls) == 2
    logits.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())


def test_train_config_reads_the_jax_json_and_round_trips():
    jcfg = jax_cfg(warmup_steps=7, base_learning_rate=3e-4, fused_flat_optimizer=True,
                   input_ring_capacity=256, augment_on_device=False, model_parallel_size=2)
    cfg = port_config(jcfg)
    assert cfg.train.warmup_steps == 7 and cfg.train.fused_flat_optimizer
    assert cfg.train.input_ring_capacity == 256 and not cfg.train.augment_on_device
    assert cfg.precision.param_dtype == "f32" and not cfg.precision.needs_loss_scaling
    assert pt_config.PrecisionConfig(compute_dtype="f16").needs_loss_scaling
    jax_fields = {f.name for f in dataclasses.fields(jax_config.TrainConfig)}
    assert jax_fields == {f.name for f in dataclasses.fields(pt_config.TrainConfig)}
    assert pt_config.TrainConfig() == port_config(jax_config.Config()).train
    back = jax_config.config_from_json(pt_config.config_to_json(cfg))
    assert back.train == jcfg.train and back.precision == jcfg.precision


# --- step ---------------------------------------------------------------------


def test_reshape_to_minibatches():
    x = torch.arange(24).reshape(6, 2, 2)
    out = pt_step.reshape_to_minibatches(x, 2)
    ref = jax_step.reshape_to_minibatches(jnp.asarray(x.numpy()), 2)
    assert out.shape == (3, 2, 2, 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        pt_step.reshape_to_minibatches(x, 4)


def test_two_train_steps_match_jax(tree):
    """A batch of 4 in 2 minibatches, two successive steps: loss,
    grads_valid and every updated parameter.  The second step's grad_scale
    of 1024 is the f16 policy's arithmetic, run in f32."""
    jcfg = jax_cfg(warmup_steps=0, base_learning_rate=1e-2, num_steps=100)
    cfg = port_config(jcfg)
    model = fresh_model(tree, cfg)
    tx, _ = jax_optim.setup_optimizers(tree, JAX_MODEL_CFG, jcfg.train)
    ref_step = jax_step.make_train_step(jcfg, tx, jax_model.make_rope(JAX_MODEL_CFG),
                                        mesh=None, ensemble=False)
    opt = pt_optim.setup_optimizers(model, cfg.model, cfg.train)
    step = pt_step.make_train_step(cfg, opt, pt_model.make_rope(cfg.model))
    # The JAX step donates its params; keep the fixture's tree out of it.
    params = jax.tree.map(jnp.copy, tree)
    opt_state = tx.init(params)
    for i, grad_scale in enumerate((1.0, 1024.0)):
        audio, labels = batch(20 + i, (2, 2), 8_000)
        ref = ref_step(params, opt_state, jnp.asarray(audio), jnp.asarray(labels),
                       jax.random.PRNGKey(i), jnp.float32(grad_scale))
        params, opt_state = ref.params, ref.opt_state
        out = step(model, torch.from_numpy(audio), torch.from_numpy(labels), grad_scale)
        assert bool(out.grads_valid) and bool(ref.grads_valid)
        close(out.loss, ref.loss, rtol=1e-5, atol=0)
        close(out.scaled_loss, ref.scaled_loss, rtol=1e-5, atol=0)
        assert_trees_close(convert.state_dict_to_jax(model.state_dict()), params,
                           rtol=1e-3, atol_of_scale=1e-6)
    assert opt.count == 2


def test_a_non_finite_step_leaves_parameters_and_optimizer_state_untouched(tree):
    cfg = port_config(jax_cfg(warmup_steps=0, base_learning_rate=1e-2, num_steps=100))
    model = fresh_model(tree, cfg)
    opt = pt_optim.setup_optimizers(model, cfg.model, cfg.train)
    step = pt_step.make_train_step(cfg, opt, pt_model.make_rope(cfg.model))
    audio, labels = batch(30, (2, 2), 8_000)
    good = step(model, torch.from_numpy(audio), torch.from_numpy(labels), 1.0)
    assert good.grads_valid and opt.count == 1
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    mu, nu = [m.clone() for m in opt.mu], [n.clone() for n in opt.nu]
    labels[1, 0, 3, 5] = np.nan
    bad = step(model, torch.from_numpy(audio), torch.from_numpy(labels), 1.0)
    assert not bool(bad.grads_valid) and not torch.isfinite(bad.loss)
    assert opt.count == 1
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
    assert all(torch.equal(a, b) for a, b in zip(opt.mu, mu))
    assert all(torch.equal(a, b) for a, b in zip(opt.nu, nu))
    again = step(model, torch.from_numpy(audio), torch.from_numpy(batch(30, (2, 2), 8_000)[1]),
                 1.0)
    assert again.grads_valid and opt.count == 2
