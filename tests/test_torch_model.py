"""The port's CNN, transformer stack and whole forward vs the JAX package, at
narrow widths and the production geometry (80 000 samples -> 250 frames).

Same params on both sides (JAX ``models/model.init`` through the
converter), same seeded numpy audio.  The JAX side runs its default serving
routes: the packed early CNN stages and the Pallas attention kernels in
interpret mode.  Tolerances (f32): rtol 1e-4 / atol 1e-5 per module; the
whole model atol 1e-4 on probabilities (errors of ~1e-6 per layer add up
over 7 stages and 2 transformer layers).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu.models import convnext as jax_convnext
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.models import transformer as jax_transformer
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.models import convnext as pt_convnext
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.models import transformer as pt_transformer
from tests.test_torch_primitives import (
    SMALL_CFG, SMALL_JAX_CFG, close, port_config, port_model, rand,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    """(JAX param tree, the same params in the port's Model)."""
    tree, _ = jax_model.init(jax.random.PRNGKey(0), SMALL_JAX_CFG)
    return tree, port_model(convert.flatten_tree(jax.device_get(tree)))


@pytest.fixture(scope="module")
def audio() -> np.ndarray:
    return rand(np.random.default_rng(1), 2, 2, 80_000) * 0.5


def test_cnn_forward_matches_jax(params, audio):
    tree, model = params
    x = np.ascontiguousarray(audio.transpose(0, 2, 1))
    ref = jax_convnext.cnn_forward(jnp.asarray(x), tree["cnn"], SMALL_JAX_CFG)
    with torch.no_grad():
        out = pt_convnext.cnn_forward(torch.from_numpy(x), model.cnn)
    assert out.shape == (2, 250, 32)
    close(out, ref)


def test_transformer_stack_matches_jax(params):
    tree, model = params
    x = rand(np.random.default_rng(2), 2, 250, 32)
    ref = jax_transformer.transformer_stack(
        jnp.asarray(x), tree["transformer"], jax_model.make_rope(SMALL_JAX_CFG), SMALL_JAX_CFG)
    with torch.no_grad():
        out = pt_transformer.transformer_stack(
            torch.from_numpy(x), model.transformer, pt_model.make_rope(SMALL_CFG.model),
            SMALL_CFG.model)
    close(out, ref)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_forward_matches_jax(params, audio, impl):
    tree, model = params
    ref_logits, ref_probs = jax_model.forward(
        tree, SMALL_JAX_CFG, jnp.asarray(audio), jax_model.make_rope(SMALL_JAX_CFG))
    cfg = dataclasses.replace(SMALL_CFG.model, attention_impl=impl)
    with torch.no_grad():
        logits, probs = pt_model.forward(model, cfg, torch.from_numpy(audio),
                                         pt_model.make_rope(cfg))
    assert probs.shape == (2, 250, 90)
    close(probs, ref_probs, rtol=0, atol=1e-4)
    close(logits, ref_logits, rtol=1e-3, atol=1e-4)


def test_bf16_forward_tracks_f32(params, audio):
    """cast_params to bf16: the same model to bf16 rounding (probabilities
    within 0.05 absolute -- bf16 keeps ~3 significant digits per op)."""
    _, model = params
    rope = pt_model.make_rope(SMALL_CFG.model)
    x = torch.from_numpy(audio)
    with torch.no_grad():
        _, ref = pt_model.forward(model, SMALL_CFG.model, x, rope)
        bf16 = pt_model.cast_params(copy.deepcopy(model), torch.bfloat16)
        _, probs = pt_model.forward(bf16, SMALL_CFG.model, x.bfloat16(), rope)
    assert probs.dtype == torch.bfloat16
    close(probs, ref, rtol=0, atol=5e-2)


def test_forward_matches_jax_at_default_widths():
    """Default widths (dims 4..256, 4 heads x 64) at depth 1 and one pair:
    the JAX side takes its default serving routes -- the packed CNN stages
    and both Pallas attention kernels (interpret mode)."""
    jax_cfg = dataclasses.replace(
        jax_config.ModelConfig(), depths=(1,) * 7, num_transformer_layers=1)
    cfg = port_config(jax_config.Config(model=jax_cfg))
    tree, _ = jax_model.init(jax.random.PRNGKey(3), jax_cfg)
    model = port_model(convert.flatten_tree(jax.device_get(tree)), cfg)
    audio = rand(np.random.default_rng(4), 1, 2, 80_000) * 0.5
    _, ref = jax_model.forward(tree, jax_cfg, jnp.asarray(audio), jax_model.make_rope(jax_cfg))
    with torch.no_grad():
        _, probs = pt_model.forward(model, cfg.model, torch.from_numpy(audio),
                                    pt_model.make_rope(cfg.model))
    close(probs, ref, rtol=0, atol=1e-4)
