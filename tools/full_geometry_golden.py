"""Writes tests/full_geometry_golden.npz: the JAX package's logits at the
default ModelConfig on the full-geometry case of tests/full_geometry.py (2
windows of seeded audio, weights filled from a seed), in f32 and, with the
parameters and the input cast to bf16, in bf16.  Runs the JAX forward on the
CPU (its Pallas kernels in interpret mode); needs JAX.

    JAX_PLATFORMS=cpu python tools/full_geometry_golden.py [--out PATH]
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
from audio_to_midi_tpu_torch import convert  # noqa: E402
from tests import full_geometry as fg  # noqa: E402


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def jax_params(cfg: jax_config.ModelConfig):
    """The JAX parameter tree of ``cfg`` filled by ``fg.weights``."""
    tree, _ = jax_model.init(jax.random.PRNGKey(0), cfg)
    flat = fg.weights({k: v.shape for k, v in convert.flatten_tree(jax.device_get(tree)).items()})
    return jax.tree_util.tree_map_with_path(lambda path, _: jnp.asarray(flat[_key(path)]), tree)


def golden_logits(dtype) -> np.ndarray:
    cfg = jax_config.DEFAULT_CONFIG.model
    params = jax_model.cast_params(jax_params(cfg), dtype)
    logits, _ = jax_model.forward(params, cfg, jnp.asarray(fg.audio(), dtype),
                                  jax_model.make_rope(cfg))
    return np.asarray(logits.astype(jnp.float32))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=str(ROOT / "tests" / fg.GOLDEN))
    args = p.parse_args(argv)
    commit = subprocess.run(["git", "log", "-1", "--format=%H", "--", "audio_to_midi_tpu"],
                            cwd=ROOT, capture_output=True, text=True).stdout.strip()
    out = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        t0 = time.perf_counter()
        out[f"logits_{name}"] = golden_logits(dtype)
        print(f"{name}: {time.perf_counter() - t0:.1f} s, largest |logit| "
              f"{np.abs(out[f'logits_{name}']).max():.4f}", flush=True)
    meta = {"weight_seed": fg.WEIGHT_SEED, "audio_seed": fg.AUDIO_SEED,
            "jax_commit": commit,
            "config": json.loads(jax_config.config_to_json(jax_config.DEFAULT_CONFIG))}
    np.savez_compressed(args.out, **out, meta=np.array(json.dumps(meta)))
    print(f"wrote {args.out} ({Path(args.out).stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
