"""The port at full geometry against the JAX package: the default
``ModelConfig`` (8 pairs of 4 heads x 64, the 7 ConvNeXt stages at their
widths and depths) on the case of ``tests/full_geometry.py`` -- 2 windows of
seeded audio and weights filled from a seed, loaded through ``convert.py``
-- held against the JAX logits in ``tests/full_geometry_golden.npz``
(``tools/full_geometry_golden.py``).  At ConvNeXt layer scale 1, where the
blocks weigh in the logits, the logits and the digest of the training
loss's gradients are held against ``tests/full_geometry_blocks_golden.npz``
(``tools/full_geometry_golden.py --blocks``).  The card holds every route
against the same files (``tests/test_torch_kernels.py``, ``chip_smoke.py``
phase 16)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.config import DEFAULT_CONFIG
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.train import loss as pt_loss
from tests import full_geometry as fg

torch.set_num_threads(2)

GOLDEN = Path(__file__).resolve().parent / fg.GOLDEN
BLOCKS_GOLDEN = GOLDEN.parent / fg.BLOCKS_GOLDEN
# Largest |logit difference| over the largest |logit|, f32 on the CPU: both
# sides sum in fp32 in their own orders through 16 attention layers and 39
# ConvNeXt blocks; read 3.1e-6.  The broken control (one global layer's
# query heads rotated) reads 0.14.
F32_LIMIT = 2e-5


# The same at layer scale 1 (tests/full_geometry_blocks_golden.npz), where
# the ConvNeXt blocks weigh: read 1.68e-6 (1.56e-6 with 6 threads), and
# 7.36e-6 in 2 of 114 runs with 6 to 8 such processes sharing 8 cores (the
# CPU's forward then sums in another order); the limit is ~4x the worst.
# The controls read 3.2e-2 (global layer 3's query heads rotated) and 0.68
# (stage 5's depthwise taps reversed).
BLOCKS_F32_LIMIT = 3e-5
# fg.grad_error of the digest of the f32 gradients of the training loss
# against JAX's (the worst leaf's largest sampled |difference| over its
# largest |g|, or its norm's relative error): read 1.22e-5 in each of 90
# runs under the same load (1.20e-5 with 6 threads), the worst leaf
# cnn/stages/0/blocks/norm/bias; the limit is ~4x that.  The controls read
# 0.26 and 2.1.
GRAD_F32_LIMIT = 5e-5


def shapes() -> dict:
    return {k: v.shape for k, v in
            convert.state_dict_to_jax(pt_model.Model(DEFAULT_CONFIG.model).state_dict()).items()}


def port_model(flat) -> pt_model.Model:
    model = pt_model.Model(DEFAULT_CONFIG.model)
    model.load_state_dict(convert.jax_to_state_dict(flat), strict=True)
    return model.eval()


def port_logits(flat) -> np.ndarray:
    cfg = DEFAULT_CONFIG.model
    with torch.no_grad():
        logits, _ = pt_model.forward(port_model(flat), cfg, torch.from_numpy(fg.audio()),
                                     pt_model.make_rope(cfg))
    return logits.numpy()


def test_port_forward_at_full_geometry_matches_the_jax_golden():
    golden = np.load(GOLDEN)
    meta = json.loads(str(golden["meta"]))
    assert meta["config"]["model"]["num_transformer_layers"] == 8
    assert golden["logits_f32"].shape == (fg.WINDOWS, 250, 90)
    flat = fg.weights(shapes())
    assert sum(v.size for v in flat.values()) == 11_606_230
    assert fg.relative_error(port_logits(flat), golden["logits_f32"]) <= F32_LIMIT
    control = port_logits(fg.rotate_heads(flat, 3, DEFAULT_CONFIG.model.num_transformer_heads))
    assert fg.relative_error(control, golden["logits_f32"]) > 100 * F32_LIMIT


def port_grad_digest(flat) -> dict:
    """The digest of the f32 gradients of the port's training loss (no
    dropout, scale 1) on the seeded labels, on JAX's leaf paths."""
    cfg = DEFAULT_CONFIG.model
    model = port_model(flat)
    loss = pt_loss.batch_loss(model, cfg, torch.from_numpy(fg.audio()),
                              torch.from_numpy(fg.labels()), pt_model.make_rope(cfg), 1.0,
                              torch.float32, enable_dropout=False)
    loss.backward()
    grads = convert.state_dict_to_jax({n: p.grad for n, p in model.named_parameters()})
    return fg.grad_digest(grads)


def blocks_case():
    golden = np.load(BLOCKS_GOLDEN)
    meta = json.loads(str(golden["meta"]))
    assert meta["layer_scale"] == fg.BLOCKS_LAYER_SCALE
    assert (meta["label_seed"], meta["digest_seed"]) == (fg.LABEL_SEED, fg.DIGEST_SEED)
    flat = fg.weights(shapes(), layer_scale=fg.BLOCKS_LAYER_SCALE)
    heads = DEFAULT_CONFIG.model.num_transformer_heads
    controls = {"rotated heads": fg.rotate_heads(flat, 3, heads),
                "reversed taps": fg.reverse_taps(flat)}
    return golden, flat, controls


def test_port_forward_at_layer_scale_one_matches_the_jax_blocks_golden():
    golden, flat, controls = blocks_case()
    assert fg.relative_error(port_logits(flat), golden["logits_f32"]) <= BLOCKS_F32_LIMIT
    for name, broken in controls.items():
        error = fg.relative_error(port_logits(broken), golden["logits_f32"])
        assert error > 100 * BLOCKS_F32_LIMIT, name


def test_port_gradients_at_layer_scale_one_match_the_jax_blocks_golden():
    golden, flat, controls = blocks_case()
    want = fg.golden_digest(golden, "f32")
    assert want["counts"].size == 123 and want["samples"].size == want["counts"].sum()
    err, leaf = fg.grad_error(port_grad_digest(flat), want)
    assert err <= GRAD_F32_LIMIT, (err, sorted(shapes())[leaf])
    for name, broken in controls.items():
        assert fg.grad_error(port_grad_digest(broken), want)[0] > 100 * GRAD_F32_LIMIT, name


def golden_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "full_geometry_golden", GOLDEN.parents[1] / "tools" / "full_geometry_golden.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.slow
def test_the_golden_file_is_what_the_jax_package_computes():
    """Recomputes both dtypes through the JAX package (~1 min on the CPU)."""
    tool = golden_tool()
    import jax.numpy as jnp

    golden = np.load(GOLDEN)
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        np.testing.assert_allclose(tool.golden_logits(dtype), golden[f"logits_{name}"],
                                   rtol=0, atol=1e-6 * np.abs(golden[f"logits_{name}"]).max())


@pytest.mark.slow
def test_the_blocks_golden_file_is_what_the_jax_package_computes():
    """Recomputes the logits and the gradient digests of both dtypes at
    layer scale 1 through the JAX package (~5 min on the CPU)."""
    tool = golden_tool()
    import jax.numpy as jnp

    golden = np.load(BLOCKS_GOLDEN)
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        np.testing.assert_allclose(tool.golden_logits(dtype, fg.BLOCKS_LAYER_SCALE),
                                   golden[f"logits_{name}"],
                                   rtol=0, atol=1e-6 * np.abs(golden[f"logits_{name}"]).max())
        _, digest = tool.golden_grads(dtype, fg.BLOCKS_LAYER_SCALE)
        assert fg.grad_error(digest, fg.golden_digest(golden, name))[0] <= 1e-6
