"""Checkpoint weight auditor (the reference's inspect_model.py), through the
PyTorch port: per-leaf min / max / mean |w| and finiteness with ASCII
histograms, warning on non-finite weights.

Usage:
  python -m audio_to_midi_tpu_torch.cli.inspect_model <checkpoint dir>
      [--step N] [--no-histograms]

The leaves are those of the flat JAX parameter layout, named by their JAX
paths (``cnn/stages/0/...``) and walked in ``jax.tree.leaves`` order, so
the lines are the JAX package's for the same parameters.  The exit code is
1 when a weight is not finite.
"""

from __future__ import annotations

import argparse
from typing import Mapping

import numpy as np


def ascii_histogram(values: np.ndarray, bins: int = 40, width: int = 60) -> str:
    finite = values[np.isfinite(values)]
    if finite.size == 0:
        return "  (no finite values)"
    counts, edges = np.histogram(finite, bins=bins)
    peak = counts.max() or 1
    lines = []
    for c, lo, hi in zip(counts, edges[:-1], edges[1:]):
        bar = "#" * int(round(width * c / peak))
        lines.append(f"  [{lo:+.3e}, {hi:+.3e}) {bar}")
    return "\n".join(lines)


def inspect_params(params: Mapping[str, np.ndarray], histograms: bool = True,
                   out=print) -> bool:
    """Dump the stats of a flat JAX parameter dict; True when every leaf is
    finite."""
    from ..convert import jax_leaf_order

    paths = jax_leaf_order(params)
    all_finite = True
    all_values = np.concatenate([np.asarray(params[p], np.float64).reshape(-1) for p in paths])
    out(f"Total parameters: {all_values.size:,}")
    out("Global histogram:")
    out(ascii_histogram(all_values))
    for path in paths:
        arr = np.asarray(params[path], np.float64)
        finite = np.isfinite(arr)
        out(f"{path}: shape={tuple(arr.shape)} min={arr.min():+.4e} "
            f"max={arr.max():+.4e} mean|w|={np.abs(arr).mean():.4e}")
        if not finite.all():
            all_finite = False
            out(f"  WARNING: {np.count_nonzero(~finite)} non-finite values!")
        if histograms:
            out(ascii_histogram(arr.reshape(-1)))
    if not all_finite:
        out("WARNING: model contains non-finite weights")
    return all_finite


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Inspect checkpoint weights.")
    parser.add_argument("checkpoint", help="Checkpoint directory")
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--no-histograms", action="store_true")
    args = parser.parse_args(argv)

    from ..train.checkpoint import restore_raw

    params, step = restore_raw(args.checkpoint, args.step)
    print(f"Inspecting checkpoint at step {step}")
    ok = inspect_params(params, histograms=not args.no_histograms)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
