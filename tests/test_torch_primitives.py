"""PyTorch port vs the JAX package: config, NN primitives, RoPE, converter,
and the port's freedom from JAX.

Inputs are made with numpy from a seed and fed to both sides.  Tolerances
(f32, on the CPU): rtol 1e-4 / atol 1e-5 -- the two frameworks sum in
different orders, and these are O(1) values.
"""

import dataclasses
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu.models import convnext as jax_convnext
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.models import nn as jax_nn
from audio_to_midi_tpu.models import rope as jax_rope
from audio_to_midi_tpu_torch import config as pt_config
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.models import convnext as pt_convnext
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.models import nn as pt_nn
from audio_to_midi_tpu_torch.models import rope as pt_rope

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5

# Narrow widths at the production geometry: 250 frames per 5 s window and
# P=256 rows of local attention.  cnn_impl="xla": the JAX package's packed
# rewrite of the small CNN stages needs the channels to double from stage to
# stage, which these dims do not; tests/test_torch_model.py holds the port
# against the packed route at the default widths.
SMALL_JAX_CFG = jax_config.ModelConfig(
    dims=(4, 8, 8, 16, 16, 32, 32),
    depths=(1, 1, 1, 1, 1, 1, 1),
    num_transformer_layers=1,
    num_transformer_heads=2,
    attention_size=16,
    compressed_attention_q_size=16,
    compressed_attention_kv_size=16,
    attention_impl="pallas",
    cnn_impl="xla",
)


def port_config(jax_cfg: jax_config.Config) -> pt_config.Config:
    """The port's config read from the JAX package's JSON."""
    return pt_config.config_from_json(jax_config.config_to_json(jax_cfg))


SMALL_CFG = port_config(jax_config.Config(model=SMALL_JAX_CFG))


def jax_params(seed: int, cfg=SMALL_JAX_CFG) -> dict[str, np.ndarray]:
    """Flat numpy JAX params of ``models/model.init``."""
    params, _ = jax_model.init(jax.random.PRNGKey(seed), cfg)
    return convert.flatten_tree(jax.device_get(params))


def port_model(flat: dict[str, np.ndarray], cfg=SMALL_CFG) -> pt_model.Model:
    model = pt_model.Model(cfg.model)
    model.load_state_dict(convert.jax_to_state_dict(flat), strict=True)
    return model.eval()


def rand(rng: np.random.Generator, *shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=rtol, atol=atol)


# --- config ---------------------------------------------------------------


def test_config_reads_the_jax_json_and_round_trips():
    jax_cfg = jax_config.Config(model=SMALL_JAX_CFG)
    cfg = port_config(jax_cfg)
    assert cfg.model.dims == SMALL_JAX_CFG.dims
    assert cfg.model.attention_impl == "pallas"
    assert cfg.precision == pt_config.PrecisionConfig("f32", "bf16")
    assert cfg.data.sample_rate == jax_cfg.data.sample_rate
    assert cfg.model.output_frames(80_000) == SMALL_JAX_CFG.output_frames(80_000) == 250
    # Every model field of the JAX config survives, TPU-only knobs included.
    jax_fields = {f.name for f in dataclasses.fields(jax_config.ModelConfig)}
    assert jax_fields == {f.name for f in dataclasses.fields(pt_config.ModelConfig)}
    back = jax_config.config_from_json(pt_config.config_to_json(cfg))
    assert back.model == SMALL_JAX_CFG
    assert back.data == jax_cfg.data and back.infer == jax_cfg.infer
    assert back.precision == jax_cfg.precision


# --- primitives -----------------------------------------------------------


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, scale, bias = rand(rng, 3, 7, 12) * 3 + 1, rand(rng, 12), rand(rng, 12)
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    ref = jax_nn.layer_norm(jnp.asarray(x), p)
    out = pt_nn.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    close(out, ref)


def test_gelu_matches_jax():
    x = rand(np.random.default_rng(1), 1000) * 4
    close(pt_nn.gelu(torch.from_numpy(x)), jax_nn.gelu(jnp.asarray(x)), atol=1e-6)


@pytest.mark.parametrize("length", [9, 40])
def test_depthwise_same_conv_matches_jax(length):
    rng = np.random.default_rng(2)
    c = 6
    x, w, b = rand(rng, 2, length, c), rand(rng, 7, 1, c), rand(rng, c)
    ref = jax_nn.conv1d(jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                        padding="SAME", groups=c)
    out = pt_nn.depthwise_conv1d_same(torch.from_numpy(x), torch.from_numpy(w),
                                      torch.from_numpy(b))
    close(out, ref)


def _load(module: torch.nn.Module, flat: dict[str, np.ndarray]) -> torch.nn.Module:
    module.load_state_dict({k.replace("/", "."): torch.tensor(v) for k, v in flat.items()})
    return module


def test_stem_and_downsample_patch_order_match_jax():
    rng = np.random.default_rng(3)
    # Stem: 2 -> 4 channels, k=s=5; a length that is not a multiple of 5.
    p_stem = {"conv": {"w": rand(rng, 5, 2, 4), "b": rand(rng, 4)},
              "norm": {"scale": rand(rng, 4), "bias": rand(rng, 4)}}
    x = rand(rng, 2, 103, 2)
    ref = jax_convnext.stem(jnp.asarray(x), jax.tree.map(jnp.asarray, p_stem))
    stem = _load(pt_convnext.Stem(4, None), convert.flatten_tree(p_stem))
    close(pt_convnext.stem(torch.from_numpy(x), stem), ref)
    # Downsample: LN then 4 -> 8 channels, k=s=2.
    p_down = {"conv": {"w": rand(rng, 2, 4, 8), "b": rand(rng, 8)},
              "norm": {"scale": rand(rng, 4), "bias": rand(rng, 4)}}
    x = rand(rng, 2, 21, 4)
    ref = jax_convnext.downsample(jnp.asarray(x), jax.tree.map(jnp.asarray, p_down))
    down = _load(pt_convnext.Downsample(4, 8, None), convert.flatten_tree(p_down))
    close(pt_convnext.downsample(torch.from_numpy(x), down), ref)


def test_convnext_block_matches_jax():
    rng = np.random.default_rng(4)
    c, hidden = 8, 16
    p = {"depth_conv": {"w": rand(rng, 7, 1, c), "b": rand(rng, c)},
         "norm": {"scale": rand(rng, c), "bias": rand(rng, c)},
         "pw1": {"w": rand(rng, c, hidden) / 3, "b": rand(rng, hidden)},
         "pw2": {"w": rand(rng, hidden, c) / 4, "b": rand(rng, c)},
         "gamma": rand(rng, c)}
    x = rand(rng, 2, 50, c)
    ref = jax_convnext.block(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                             sdd_rate=0.0, enable_sdd=False, key=None)
    blk = _load(pt_convnext.Block(c, hidden, None), convert.flatten_tree(p))
    close(pt_convnext.block(torch.from_numpy(x), blk), ref)


def test_rope_tables_and_rotation_match_jax():
    ref = jax_rope.precompute_frequencies(64, 300)
    tables = pt_rope.precompute_frequencies(64, 300)
    # Angles reach 299 rad; one f32 ulp of a frequency moves them ~2e-5.
    close(tables.cos, ref.cos, atol=3e-5)
    close(tables.sin, ref.sin, atol=3e-5)
    x = rand(np.random.default_rng(5), 2, 250, 4, 64)
    out = pt_rope.apply_rope_halves(torch.from_numpy(x), tables)
    close(out, jax_rope.apply_rope_halves(jnp.asarray(x), ref), atol=2e-4)
    # Same tables on both sides: the rotation itself agrees to f32 rounding.
    same = pt_rope.RopeFreqs(torch.tensor(np.asarray(ref.cos)),
                             torch.tensor(np.asarray(ref.sin)))
    close(pt_rope.apply_rope_halves(torch.from_numpy(x), same),
          jax_rope.apply_rope_halves(jnp.asarray(x), ref))


def test_init_scales_match_jax():
    """The port's seeded init draws at the JAX package's scales: uniform
    +-1/sqrt(fan_in) weights and biases, LayerNorm ones/zeros, gamma 1e-6."""
    model = pt_model.Model(SMALL_CFG.model, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    ref = jax_params(0)
    back = convert.state_dict_to_jax(model.state_dict())
    assert sorted(back) == sorted(ref)
    for key, value in ref.items():
        assert back[key].shape == value.shape, key
        if key.endswith(("/scale", "/bias", "gamma")):
            np.testing.assert_array_equal(back[key], value, err_msg=key)
    for key, value in sd.items():
        if not key.endswith((".w", ".b")):
            continue
        w = sd[key[:-1] + "w"]
        bound = 1.0 / np.sqrt(np.prod(w.shape[:-1]))  # fan_in of (in, out) and WIO
        assert np.abs(value).max() <= bound, key
        if value.size >= 16:
            assert np.abs(value).max() >= 0.5 * bound, key


# --- converter ------------------------------------------------------------


def test_converter_round_trip_is_bit_exact(tmp_path):
    flat = jax_params(1)
    sd = convert.jax_to_state_dict(flat)
    # Stacked leaves unstack into ModuleList entries the model accepts.
    model = pt_model.Model(SMALL_CFG.model)
    model.load_state_dict(sd, strict=True)
    assert "cnn.stages.5.blocks.0.pw1.w" in sd
    assert "transformer.layers.0.global.attention.q_up.w" in sd
    back = convert.state_dict_to_jax(model.state_dict())
    assert sorted(back) == sorted(flat)
    for key in flat:
        assert back[key].dtype == flat[key].dtype, key
        np.testing.assert_array_equal(back[key], flat[key], err_msg=key)
    path = tmp_path / "params.npz"
    convert.save_npz(path, back)
    loaded = convert.load_npz(path)
    for key in flat:
        np.testing.assert_array_equal(loaded[key], flat[key], err_msg=key)


def test_converter_restacks_deep_stages():
    cfg = dataclasses.replace(SMALL_JAX_CFG, depths=(1, 2, 1, 1, 1, 3, 1),
                              num_transformer_layers=2)
    flat = jax_params(2, cfg)
    back = convert.state_dict_to_jax(convert.jax_to_state_dict(flat))
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key], err_msg=key)


# --- no JAX in the port ---------------------------------------------------


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import audio_to_midi_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        assert len(names) >= 55, names
        assert {"audio_to_midi_tpu_torch.train." + m for m in ("loss", "optim", "step")} <= set(names)
        assert "audio_to_midi_tpu_torch.ops.fused_layer_kernels" in names
        assert {"audio_to_midi_tpu_torch." + m for m in (
            "native", "data.loader", "data.index_shuffle", "data.device_ring",
            "data.augment_device", "train.loop", "train.checkpoint", "train.evaluate",
            "cli.train_cli", "train.ensemble", "train.init_surgery", "cli.infer_cli",
            "cli.copy_weights", "cli.inspect_model", "parallel.mesh", "parallel.tp", "export",
            "modelutil",
            "utils.profiling", "utils.visualize")
        } <= set(names)
        leaked = sorted(m for m in sys.modules
                        if m in ("jax", "optax", "audio_to_midi_tpu")
                        or m.startswith(("jax.", "optax.", "audio_to_midi_tpu.")))
        assert not leaked, leaked
        optional = sorted(m for m in sys.modules
                          if m.split(".")[0] in ("tensorboard", "grain", "matplotlib", "triton"))
        assert not optional, optional
        print("ok", len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
