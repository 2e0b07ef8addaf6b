"""Writes tests/full_geometry_golden.npz: the JAX package's logits at the
default ModelConfig on the full-geometry case of tests/full_geometry.py (2
windows of seeded audio, weights filled from a seed), in f32 and, with the
parameters and the input cast to bf16, in bf16.  Runs the JAX forward on the
CPU (its Pallas kernels in interpret mode); needs JAX.

With ``--blocks`` it writes tests/full_geometry_blocks_golden.npz instead:
the same at ConvNeXt layer scale 1 (``BLOCKS_LAYER_SCALE``), and beside the
logits the digests (``grad_digest``) of the gradients of the JAX training
loss (``train/loss.batch_loss``, scale 1, no dropout) on the seeded labels:
in f32, and in bf16 as the JAX step takes it, the f32 parameters cast to
bf16 inside the loss.

    JAX_PLATFORMS=cpu python tools/full_geometry_golden.py [--blocks] [--out PATH]

The first takes ~1 min of CPU, the second ~5.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from audio_to_midi_tpu import config as jax_config  # noqa: E402
from audio_to_midi_tpu.models import model as jax_model  # noqa: E402
from audio_to_midi_tpu.train import loss as jax_loss  # noqa: E402
from audio_to_midi_tpu_torch import convert  # noqa: E402
from tests import full_geometry as fg  # noqa: E402


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def jax_params(cfg: jax_config.ModelConfig, layer_scale: float = fg.LAYER_SCALE_INIT):
    """The JAX parameter tree of ``cfg`` filled by ``fg.weights``."""
    tree, _ = jax_model.init(jax.random.PRNGKey(0), cfg)
    flat = fg.weights({k: v.shape for k, v in convert.flatten_tree(jax.device_get(tree)).items()},
                      layer_scale=layer_scale)
    return jax.tree_util.tree_map_with_path(lambda path, _: jnp.asarray(flat[_key(path)]), tree)


def golden_logits(dtype, layer_scale: float = fg.LAYER_SCALE_INIT) -> np.ndarray:
    cfg = jax_config.DEFAULT_CONFIG.model
    params = jax_model.cast_params(jax_params(cfg, layer_scale), dtype)
    logits, _ = jax_model.forward(params, cfg, jnp.asarray(fg.audio(), dtype),
                                  jax_model.make_rope(cfg))
    return np.asarray(logits.astype(jnp.float32))


def golden_grads(dtype, layer_scale: float = fg.BLOCKS_LAYER_SCALE) -> tuple[float, dict]:
    """The loss and the ``fg.grad_digest`` of its gradients, with the
    forward in ``dtype`` over the f32 parameters."""
    cfg = jax_config.DEFAULT_CONFIG.model
    grad_fn = jax.jit(jax.value_and_grad(jax_loss.batch_loss), static_argnums=(1, 7, 8))
    loss, grads = grad_fn(jax_params(cfg, layer_scale), cfg, jnp.asarray(fg.audio()),
                          jnp.asarray(fg.labels()), jax_model.make_rope(cfg), jnp.float32(1.0),
                          None, dtype, False)
    return float(loss), fg.grad_digest(convert.flatten_tree(jax.device_get(grads)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--blocks", action="store_true",
                   help="layer scale 1 and the loss gradients' digests")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    out_path = args.out or str(ROOT / "tests" / (fg.BLOCKS_GOLDEN if args.blocks else fg.GOLDEN))
    layer_scale = fg.BLOCKS_LAYER_SCALE if args.blocks else fg.LAYER_SCALE_INIT
    commit = subprocess.run(["git", "log", "-1", "--format=%H", "--", "audio_to_midi_tpu"],
                            cwd=ROOT, capture_output=True, text=True).stdout.strip()
    out = {}
    losses = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        t0 = time.perf_counter()
        out[f"logits_{name}"] = golden_logits(dtype, layer_scale)
        print(f"{name}: {time.perf_counter() - t0:.1f} s, largest |logit| "
              f"{np.abs(out[f'logits_{name}']).max():.4f}", flush=True)
        if args.blocks:
            t0 = time.perf_counter()
            losses[name], digest = golden_grads(dtype, layer_scale)
            out |= {f"grads_{name}_{k}": v for k, v in digest.items()}
            print(f"{name} gradients: {time.perf_counter() - t0:.1f} s, loss {losses[name]:.4f}, "
                  f"smallest leaf max |g| {digest['max'].min():.3e}", flush=True)
    meta = {"weight_seed": fg.WEIGHT_SEED, "audio_seed": fg.AUDIO_SEED,
            "jax_commit": commit,
            "config": json.loads(jax_config.config_to_json(jax_config.DEFAULT_CONFIG))}
    if args.blocks:
        meta |= {"layer_scale": layer_scale, "label_seed": fg.LABEL_SEED,
                 "digest_seed": fg.DIGEST_SEED, "digest_samples": fg.DIGEST_SAMPLES,
                 "loss": losses}
    np.savez_compressed(out_path, **out, meta=np.array(json.dumps(meta)))
    print(f"wrote {out_path} ({Path(out_path).stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
