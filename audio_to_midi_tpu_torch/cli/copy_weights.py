"""Architecture-migration tool (the reference's copy_weights.py), through the
PyTorch port: load an old checkpoint, build a model with the current
config, greedily copy the leaves that match in shape and dtype in flattened
order, and save the result as a step-0 checkpoint with the new metadata.

Usage:
  python -m audio_to_midi_tpu_torch.cli.copy_weights <source> <dest>
      [--ensemble-size E] [--config JSON]

``source`` and ``dest`` are port checkpoint directories
(``train/checkpoint.py``).  The leaves are those of the flat JAX parameter
layout in ``jax.tree.leaves`` order (``convert.jax_leaf_order``), so the
copy is the JAX package's, leaf for leaf.  ``--config`` (default: the
default config) gives the new architecture.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Mapping

import numpy as np


def copy_matching_leaves(old_params: Mapping[str, np.ndarray],
                         new_params: Mapping[str, np.ndarray]) -> tuple[dict, int, int]:
    """Greedy in-order copy of the leaves that match in shape and dtype
    (reference copy_weights.py:48-58): walk both leaf lists in order; at each
    new leaf, consume old leaves until one matches.  Both are flat JAX
    parameter dicts.  Returns (merged flat dict, copied count, fresh count)."""
    from ..convert import jax_leaf_order

    old_leaves = [np.asarray(old_params[path]) for path in jax_leaf_order(old_params)]
    merged = {}
    copied = 0
    old_idx = 0
    new_paths = jax_leaf_order(new_params)
    for path in new_paths:
        leaf = np.asarray(new_params[path])
        found = next((j for j in range(old_idx, len(old_leaves))
                      if old_leaves[j].shape == leaf.shape and old_leaves[j].dtype == leaf.dtype),
                     None)
        if found is not None:
            merged[path] = old_leaves[found]
            old_idx = found + 1
            copied += 1
        else:
            merged[path] = leaf
    return merged, copied, len(new_paths) - copied


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Copy weights from an old checkpoint into the current architecture.")
    parser.add_argument("source", help="Source checkpoint directory")
    parser.add_argument("dest", help="Destination checkpoint directory")
    parser.add_argument("--ensemble-size", type=int, default=1)
    parser.add_argument("--config", default=None, help="Config JSON file (the new architecture)")
    args = parser.parse_args(argv)

    import torch

    from ..config import load_config
    from ..models import model as model_lib
    from ..train import checkpoint as ckpt

    cfg = load_config(args.config)
    old_params, step = ckpt.restore_raw(args.source)
    print(f"Loaded source checkpoint at step {step}")

    new_model, state = model_lib.init_ensemble(torch.Generator().manual_seed(0), cfg.model,
                                               args.ensemble_size)
    merged, copied, fresh = copy_matching_leaves(old_params, ckpt.params_to_jax(new_model))
    print(f"Copied {copied} leaves, kept {fresh} freshly-initialized leaves")

    manager = ckpt.create_checkpoint_manager(Path(args.dest), cfg, save_interval_steps=1)
    manager.save(0, merged, state)
    print(f"Saved migrated checkpoint (step 0) to {args.dest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
