"""The full-geometry parity case, in numpy alone: the input and the weights
that the port and the JAX package both take at the default ``ModelConfig``.

``tools/full_geometry_golden.py`` runs the JAX package's forward on them (on
the CPU) and writes its logits into ``tests/full_geometry_golden.npz``;
``tests/test_torch_full_geometry.py`` holds the port's plain forward
against that file on the CPU, and ``chip_smoke.py`` every route of the
port on the card, where there is no JAX.  Both sides build the weights from
:func:`weights` over the JAX parameter tree's leaf paths and shapes, and the
port loads them through ``convert.py``: the 11.6 M parameters are too large
to commit.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np

WEIGHT_SEED = 19
AUDIO_SEED = 20
WINDOWS = 2
SAMPLES = 80_000  # 5 s at 16 kHz: the default samples_per_window
GOLDEN = "full_geometry_golden.npz"
LAYER_SCALE_INIT = 1e-6  # the JAX package's ConvNeXt gamma


def audio(seed: int = AUDIO_SEED) -> np.ndarray:
    """(WINDOWS, 2, SAMPLES) float32 of unit variance."""
    return np.random.default_rng(seed).standard_normal((WINDOWS, 2, SAMPLES)).astype(np.float32)


def _stacked(path: str) -> bool:
    """Leaves with a leading stack axis: a stage's blocks, or the layers of
    the transformer."""
    return "/blocks/" in path or path.startswith("transformer/")


def weights(shapes: Mapping[str, tuple[int, ...]], seed: int = WEIGHT_SEED) -> dict[str, np.ndarray]:
    """Float32 leaves for ``shapes`` (JAX leaf path -> shape), drawn in
    sorted path order from one generator at the JAX package's init scales:
    products (``w``) normal with standard deviation 1/sqrt(fan in), norm
    scales ones, biases zeros, the ConvNeXt layer scale ``gamma`` at its
    init.  The fan in of a product is every axis but the last (a stacked
    leaf's first axis aside)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path in sorted(shapes):
        shape = tuple(shapes[path])
        name = path.rsplit("/", 1)[-1]
        if name == "w":
            fan_in = math.prod(shape[1:-1] if _stacked(path) else shape[:-1])
            out[path] = (rng.standard_normal(shape) / math.sqrt(fan_in)).astype(np.float32)
        elif name == "scale":
            out[path] = np.ones(shape, np.float32)
        elif name in ("b", "bias"):
            out[path] = np.zeros(shape, np.float32)
        elif name == "gamma":
            out[path] = np.full(shape, LAYER_SCALE_INIT, np.float32)
        else:
            raise ValueError(f"no fill rule for the leaf {path}")
    return out


def rotate_heads(flat: Mapping[str, np.ndarray], layer: int, num_heads: int) -> dict[str, np.ndarray]:
    """The broken control: ``flat`` with the query heads of global layer
    ``layer`` rotated by one head (head h takes head h - 1's columns of
    ``q_up``), which moves every logit of that layer's attention."""
    out = dict(flat)
    key = "transformer/global/attention/q_up/w"
    w = np.array(flat[key])
    d = w.shape[-1]
    heads = w[layer].reshape(w.shape[1], num_heads, d // num_heads)
    w[layer] = np.roll(heads, 1, axis=1).reshape(w.shape[1], d)
    out[key] = w
    return out


def relative_error(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |difference| over the largest |want|."""
    return float(np.max(np.abs(got.astype(np.float64) - want)) / np.max(np.abs(want)))
