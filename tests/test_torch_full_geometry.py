"""The port at full geometry against the JAX package: the default
``ModelConfig`` (8 pairs of 4 heads x 64, the 7 ConvNeXt stages at their
widths and depths) on the case of ``tests/full_geometry.py`` -- 2 windows of
seeded audio and weights filled from a seed, loaded through ``convert.py``
-- held against the JAX logits in ``tests/full_geometry_golden.npz``
(``tools/full_geometry_golden.py``).  The card holds every route against
the same file (``tests/test_torch_kernels.py``, ``chip_smoke.py``)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.config import DEFAULT_CONFIG
from audio_to_midi_tpu_torch.models import model as pt_model
from tests import full_geometry as fg

torch.set_num_threads(2)

GOLDEN = Path(__file__).resolve().parent / fg.GOLDEN
# Largest |logit difference| over the largest |logit|, f32 on the CPU: both
# sides sum in fp32 in their own orders through 16 attention layers and 39
# ConvNeXt blocks; read 3.1e-6.  The broken control (one global layer's
# query heads rotated) reads 0.14.
F32_LIMIT = 2e-5


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
    shapes = {k: v.shape for k, v in
              convert.state_dict_to_jax(pt_model.Model(DEFAULT_CONFIG.model).state_dict()).items()}
    flat = fg.weights(shapes)
    assert sum(v.size for v in flat.values()) == 11_606_230
    assert fg.relative_error(port_logits(flat), golden["logits_f32"]) <= F32_LIMIT
    control = port_logits(fg.rotate_heads(flat, 3, DEFAULT_CONFIG.model.num_transformer_heads))
    assert fg.relative_error(control, golden["logits_f32"]) > 100 * F32_LIMIT


@pytest.mark.slow
def test_the_golden_file_is_what_the_jax_package_computes():
    """Recomputes both dtypes through the JAX package (~1 min on the CPU)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "full_geometry_golden", GOLDEN.parents[1] / "tools" / "full_geometry_golden.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    import jax.numpy as jnp

    golden = np.load(GOLDEN)
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        np.testing.assert_allclose(tool.golden_logits(dtype), golden[f"logits_{name}"],
                                   rtol=0, atol=1e-6 * np.abs(golden[f"logits_{name}"]).max())
