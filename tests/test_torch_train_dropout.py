"""The port's training with dropout: ``nn.dropout``, the feed-forward and
alternating layers against the JAX package under shared masks, CNN
stochastic depth, the model and the training step.

The two frameworks draw different random numbers from one seed, so wherever
the two sides are compared the test hands both the same masks, made with
numpy: on the JAX side it replaces ``pallas_attention.random_bits_fast`` (the
bits of its precomputed-bits kernels, which its CPU runs take) and
``nn.dropout``; on the port's side its two mask sources,
``attention_kernels.philox_bits_plain`` and ``nn.dropout_mask``.  The JAX
side runs ``attention_impl="pallas"`` in interpret mode.  Tolerance (f32):
1e-5 of the largest magnitude of the compared tensor -- the same arithmetic
summed in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu.models import convnext as jax_convnext
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.models import nn as jax_nn
from audio_to_midi_tpu.models import transformer as jax_transformer
from audio_to_midi_tpu.ops import pallas_attention as pa
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.models import convnext as pt_convnext
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.models import nn as pt_nn
from audio_to_midi_tpu_torch.models import transformer as pt_transformer
from audio_to_midi_tpu_torch.ops import attention_kernels as ak
from audio_to_midi_tpu_torch.train import optim as pt_optim
from audio_to_midi_tpu_torch.train import step as pt_step
from tests.test_torch_primitives import SMALL_CFG, SMALL_JAX_CFG, close, rand
from tests.test_torch_train import batch, fresh_model, jax_cfg, port_config, tree  # noqa: F401

torch.set_num_threads(2)

RATE = SMALL_JAX_CFG.transformer_dropout_rate  # 0.1, the reference-parity rate
HEADS = SMALL_JAX_CFG.num_transformer_heads


def assert_close_to_scale(mine, ref, what=""):
    mine, ref = np.asarray(mine, np.float32), np.asarray(ref, np.float32)
    limit = 1e-5 * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(mine - ref).max()) <= limit, what


# --- nn.dropout ----------------------------------------------------------------


def test_dropout_is_inverted_at_the_exact_rate():
    x = torch.ones(200, 500)
    out = pt_nn.dropout(x, 0.1, torch.Generator().manual_seed(0), True)
    kept = out != 0
    assert torch.allclose(out[kept], torch.tensor(1.0 / 0.9))
    p, n = 0.9, x.numel()
    assert abs(kept.float().mean().item() - p) <= 4 * (p * (1 - p) / n) ** 0.5
    assert abs(out.mean().item() - 1.0) < 5e-3  # unbiased


def test_dropout_is_a_no_op_when_disabled_or_at_rate_zero():
    x = torch.randn(4, 5, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    state = gen.get_state()
    assert pt_nn.dropout(x, 0.5, gen, False) is x
    assert pt_nn.dropout(x, 0.0, gen, True) is x
    assert pt_nn.dropout(x, 0.0, None, True) is x
    assert torch.equal(gen.get_state(), state)  # nothing was drawn
    with pytest.raises(ValueError, match="generator"):
        pt_nn.dropout(x, 0.5, None, True)
    assert not pt_nn.dropout(x, 1.0, gen, True).any()  # keeps nothing, and no nan


def test_dropout_follows_its_generator_and_not_the_global_state():
    x = torch.ones(64, 64)
    torch.manual_seed(0)
    a = pt_nn.dropout(x, 0.3, torch.Generator().manual_seed(5), True)
    torch.manual_seed(1)
    b = pt_nn.dropout(x, 0.3, torch.Generator().manual_seed(5), True)
    c = pt_nn.dropout(x, 0.3, torch.Generator().manual_seed(6), True)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_dropout_matches_jax_under_the_same_mask(monkeypatch):
    rng = np.random.default_rng(0)
    x, mask = rand(rng, 3, 7, 16), rng.random((3, 7, 16)) < 0.75
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(mask))
    monkeypatch.setattr(pt_nn, "dropout_mask", lambda *a: torch.from_numpy(mask))
    ref = jax_nn.dropout(jnp.asarray(x), 0.25, jax.random.PRNGKey(0), True)
    out = pt_nn.dropout(torch.from_numpy(x), 0.25, torch.Generator(), True)
    close(out, ref, rtol=1e-6, atol=0)


# --- the layers against the JAX package under shared masks -------------------


class SharedMasks:
    """The masks of one alternating layer, handed to both sides."""

    def __init__(self, seed: int, b: int, s: int, d: int, p_len: int, s_pad: int):
        rng = np.random.default_rng(seed)
        self.local_bits = rng.integers(0, 256, (2, b, HEADS, p_len, p_len), dtype=np.uint8)
        self.global_bits = rng.integers(0, 256, (b, HEADS, s_pad, s_pad), dtype=np.uint8)
        self.ffn_masks = [rng.random((b, s, d)) >= RATE for _ in range(2)]  # local, global

    def patch(self, monkeypatch):
        jax_ffn, port_ffn = iter(self.ffn_masks), iter(self.ffn_masks)

        def jax_bits(key, shape):
            bits = self.local_bits if len(shape) == 5 else self.global_bits
            assert tuple(shape) == bits.shape
            return jnp.asarray(bits)

        def jax_dropout(x, rate, key, enabled, fast_rng=False):
            if not enabled:
                return x
            assert rate == RATE
            return jnp.where(jnp.asarray(next(jax_ffn)), x / (1.0 - rate), jnp.zeros_like(x))

        def port_bits(seed, samples, cores, p_len):
            if cores == 2 * HEADS:  # the two-phase streams: phase A's planes first
                return torch.from_numpy(np.concatenate(list(self.local_bits), axis=1))
            return torch.from_numpy(np.ascontiguousarray(self.global_bits[:, :, :p_len, :p_len]))

        monkeypatch.setattr(pa, "random_bits_fast", jax_bits)
        monkeypatch.setattr(jax_nn, "dropout", jax_dropout)
        monkeypatch.setattr(ak, "philox_bits_plain", port_bits)
        monkeypatch.setattr(pt_nn, "dropout_mask",
                            lambda shape, keep, gen, device: torch.from_numpy(next(port_ffn)))


def _layer_pair(seed: int):
    p = jax_transformer.init_alternating_layer(jax.random.PRNGKey(seed), SMALL_JAX_CFG)
    flat = convert.flatten_tree(jax.device_get(p))
    module = pt_transformer.AlternatingLayer(SMALL_CFG.model)
    module.load_state_dict({k.replace("/", "."): torch.tensor(v) for k, v in flat.items()})
    return p, module


def test_feed_forward_with_dropout_matches_jax(monkeypatch):
    p, module = _layer_pair(0)
    masks = SharedMasks(1, 2, 50, 32, 16, 16)
    masks.patch(monkeypatch)
    x = rand(np.random.default_rng(2), 2, 50, 32)
    ref = jax_transformer.feed_forward(jnp.asarray(x), p["local"]["ff"], dropout_rate=RATE,
                                       key=jax.random.PRNGKey(0), enable_dropout=True)
    with torch.no_grad():
        out = pt_transformer.feed_forward(
            torch.from_numpy(x), module.get_submodule("local").ff, dropout_rate=RATE,
            generator=torch.Generator(), enable_dropout=True)
    assert_close_to_scale(out, ref)
    assert (np.asarray(ref) == 0).mean() > 0.05  # the mask was applied


def test_alternating_layer_with_dropout_matches_jax_under_shared_masks(monkeypatch):
    """One (local, global) pair at the production geometry (250 frames, local
    P = 256) with attention-weight and feed-forward dropout on: outputs and
    parameter gradients."""
    b, s, d = 2, 250, 32
    p, module = _layer_pair(3)
    SharedMasks(4, b, s, d, 256, 256).patch(monkeypatch)
    rng = np.random.default_rng(5)
    x, cot = rand(rng, b, s, d), rand(rng, b, s, d)
    jax_rope, rope = jax_model.make_rope(SMALL_JAX_CFG), pt_model.make_rope(SMALL_CFG.model)

    def jax_loss(p):
        out = jax_transformer.alternating_layer(jnp.asarray(x), p, jax_rope, SMALL_JAX_CFG,
                                                key=jax.random.PRNGKey(6), enable_dropout=True)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, ref), ref_grads = jax.value_and_grad(jax_loss, has_aux=True)(p)
    free = jax_transformer.alternating_layer(jnp.asarray(x), p, jax_rope, SMALL_JAX_CFG)
    assert float(jnp.abs(ref - free).max()) > 1e-2  # dropout did something

    out = pt_transformer.alternating_layer(torch.from_numpy(x), module, rope, SMALL_CFG.model,
                                           generator=torch.Generator().manual_seed(0),
                                           enable_dropout=True)
    assert_close_to_scale(out.detach(), ref, "outputs")
    (out * torch.from_numpy(cot)).sum().backward()
    ref_flat = convert.flatten_tree(jax.device_get(ref_grads))
    grads = {n.replace(".", "/"): q.grad.numpy() for n, q in module.named_parameters()}
    assert grads.keys() == ref_flat.keys()
    for name, r in ref_flat.items():
        assert_close_to_scale(grads[name], r, name)


# --- CNN stochastic depth -------------------------------------------------------


def test_stochastic_depth_schedule_matches_jax():
    np.testing.assert_allclose(pt_convnext.sdd_schedule(SMALL_CFG.model),
                               jax_convnext.sdd_schedule(SMALL_JAX_CFG), rtol=1e-12)


def test_stochastic_depth_drops_a_whole_branch_per_sample():
    blk = pt_convnext.Block(8, 16, torch.Generator().manual_seed(0))
    with torch.no_grad():
        blk.gamma.fill_(1.0)
    x = torch.randn(16, 20, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full = pt_convnext.block(x, blk)
        never = pt_convnext.block(x, blk, sdd_rate=0.0, generator=torch.Generator().manual_seed(2))
        always = pt_convnext.block(x, blk, sdd_rate=1.0, generator=torch.Generator().manual_seed(2))
        half = pt_convnext.block(x, blk, sdd_rate=0.5, generator=torch.Generator().manual_seed(3))
    assert torch.equal(never, full) and torch.equal(always, x)
    dropped = [torch.equal(half[i], x[i]) for i in range(16)]
    kept = [torch.equal(half[i], full[i]) for i in range(16)]
    assert all(a != b for a, b in zip(dropped, kept)) and any(dropped) and any(kept)


def test_stochastic_depth_is_inert_unless_the_configuration_enables_it():
    cfg = dataclasses.replace(SMALL_CFG.model, transformer_dropout_rate=0.0)
    model = pt_model.Model(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(2, 8_000, 2, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    state = gen.get_state()
    with torch.no_grad():
        off = pt_convnext.cnn_forward(x, model.cnn, cfg, generator=gen, enable_dropout=True)
        assert torch.equal(gen.get_state(), state)  # inert: nothing drawn
        assert torch.equal(off, pt_convnext.cnn_forward(x, model.cnn, cfg))
        on_cfg = dataclasses.replace(cfg, enable_cnn_stochastic_depth=True, sdd_rate=0.9)
        on = pt_convnext.cnn_forward(x, model.cnn, on_cfg, generator=gen, enable_dropout=True)
        assert not torch.equal(gen.get_state(), state)
        assert not torch.equal(on, off)
        # Without enable_dropout the switch alone does nothing.
        assert torch.equal(pt_convnext.cnn_forward(x, model.cnn, on_cfg), off)
    with pytest.raises(ValueError, match="generator"):
        pt_convnext.cnn_forward(x, model.cnn, on_cfg, enable_dropout=True)


# --- the model and the step ---------------------------------------------------


def test_forward_with_the_default_dropout_rate_runs_and_follows_its_generator(tree):  # noqa: F811
    cfg = port_config(jax_cfg())
    model_cfg = dataclasses.replace(cfg.model, transformer_dropout_rate=RATE)
    model = fresh_model(tree, cfg)
    audio = torch.from_numpy(batch(1, (2,), 8_000)[0])
    rope = pt_model.make_rope(model_cfg)
    run = lambda c, seed: pt_model.forward(model, c, audio, rope, enable_dropout=True,
                                           generator=torch.Generator().manual_seed(seed))[0]
    with torch.no_grad():
        a, b, c = run(model_cfg, 0), run(model_cfg, 0), run(model_cfg, 1)
        free = pt_model.forward(model, model_cfg, audio, rope)[0]
        plain = run(dataclasses.replace(model_cfg, attention_impl="xla"), 0)
    assert torch.isfinite(a).all() and torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, free)
    # "xla" drops at the exact rate through nn.dropout (the JAX einsum
    # route): it follows its generator too, with masks of its own.
    plain_again = run(dataclasses.replace(model_cfg, attention_impl="xla"), 0)
    assert torch.isfinite(plain).all() and torch.equal(plain, plain_again)
    assert not torch.equal(plain, a)


def _two_steps(tree, rate: float, seed: int | None, num_samples: int = 8_000):  # noqa: F811
    cfg = port_config(jax_cfg(warmup_steps=0))
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, transformer_dropout_rate=rate))
    model = fresh_model(tree, cfg).train()
    optimizer = pt_optim.setup_optimizers(model, cfg.model, cfg.train)
    step = pt_step.make_train_step(cfg, optimizer, pt_model.make_rope(cfg.model))
    audio, labels = (torch.from_numpy(a) for a in batch(7, (2, 2), num_samples))
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    outs = [step(model, audio, labels, 1.0, gen) for _ in range(2)]
    return outs, [q.detach().clone() for q in model.parameters()]


def test_train_steps_with_dropout_are_finite_and_follow_the_generator(tree):  # noqa: F811
    outs, params = _two_steps(tree, RATE, 0)
    assert all(o.grads_valid and torch.isfinite(o.loss) for o in outs)
    again, params_again = _two_steps(tree, RATE, 0)
    assert [o.loss.item() for o in again] == [o.loss.item() for o in outs]
    assert all(torch.equal(a, b) for a, b in zip(params, params_again))
    other, params_other = _two_steps(tree, RATE, 1)
    assert other[0].loss.item() != outs[0].loss.item()
    assert not all(torch.equal(a, b) for a, b in zip(params, params_other))
    with pytest.raises(ValueError, match="generator"):
        _two_steps(tree, RATE, None)


def test_train_steps_at_rate_zero_are_the_dropout_free_steps(tree):  # noqa: F811
    with_gen, params = _two_steps(tree, 0.0, 0)
    without, params_free = _two_steps(tree, 0.0, None)
    assert [o.loss.item() for o in with_gen] == [o.loss.item() for o in without]
    assert all(torch.equal(a, b) for a, b in zip(params, params_free))
    dropped, _ = _two_steps(tree, RATE, 0)
    assert dropped[0].loss.item() != without[0].loss.item()


def test_minibatches_draw_from_generators_of_their_own():
    gen = torch.Generator().manual_seed(3)
    a = pt_step.minibatch_generator(gen, torch.device("cpu"))
    b = pt_step.minibatch_generator(gen, torch.device("cpu"))
    assert a.initial_seed() != b.initial_seed()
    again = pt_step.minibatch_generator(torch.Generator().manual_seed(3), torch.device("cpu"))
    assert again.initial_seed() == a.initial_seed()
    assert pt_step.minibatch_generator(None, torch.device("cpu")) is None
