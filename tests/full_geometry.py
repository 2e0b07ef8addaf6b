"""The full-geometry parity case, in numpy alone: the input and the weights
that the port and the JAX package both take at the default ``ModelConfig``.

``tools/full_geometry_golden.py`` runs the JAX package's forward on them (on
the CPU) and writes its logits into ``tests/full_geometry_golden.npz``, at
the JAX init's ConvNeXt layer scale; with ``--blocks`` it writes
``tests/full_geometry_blocks_golden.npz`` at layer scale 1, where the
ConvNeXt blocks weigh in the logits, with the digests
(:func:`grad_digest`) of the JAX loss gradients on the seeded
:func:`labels` beside them.  ``tests/test_torch_full_geometry.py`` holds
the port's plain forward and backward against those files on the CPU, and
``chip_smoke.py`` every route of the port on the card, where there is no
JAX.  Both sides build the weights from
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
LABEL_SEED = 21
DIGEST_SEED = 22
WINDOWS = 2
SAMPLES = 80_000  # 5 s at 16 kHz: the default samples_per_window
FRAMES = 250  # the model's output frames per window
KEYS = 90
GOLDEN = "full_geometry_golden.npz"
BLOCKS_GOLDEN = "full_geometry_blocks_golden.npz"
LAYER_SCALE_INIT = 1e-6  # the JAX package's ConvNeXt gamma
# The blocks' case: every ConvNeXt branch at full weight.  A fault in a
# block (stage 5's taps reversed, say) then moves the logits by 0.68 of
# their largest value, where at the init scale it hardly moves them.
BLOCKS_LAYER_SCALE = 1.0
DIGEST_SAMPLES = 256  # sampled values per gradient leaf


def audio(seed: int = AUDIO_SEED) -> np.ndarray:
    """(WINDOWS, 2, SAMPLES) float32 of unit variance."""
    return np.random.default_rng(seed).standard_normal((WINDOWS, 2, SAMPLES)).astype(np.float32)


def labels(seed: int = LABEL_SEED) -> np.ndarray:
    """(WINDOWS, FRAMES, KEYS) float32 targets, each 1 with probability 0.05."""
    rng = np.random.default_rng(seed)
    return (rng.random((WINDOWS, FRAMES, KEYS)) < 0.05).astype(np.float32)


def _stacked(path: str) -> bool:
    """Leaves with a leading stack axis: a stage's blocks, or the layers of
    the transformer."""
    return "/blocks/" in path or path.startswith("transformer/")


def weights(shapes: Mapping[str, tuple[int, ...]], seed: int = WEIGHT_SEED,
            layer_scale: float = LAYER_SCALE_INIT) -> dict[str, np.ndarray]:
    """Float32 leaves for ``shapes`` (JAX leaf path -> shape), drawn in
    sorted path order from one generator at the JAX package's init scales:
    products (``w``) normal with standard deviation 1/sqrt(fan in), norm
    scales ones, biases zeros, the ConvNeXt layer scale ``gamma`` at
    ``layer_scale`` (by default its init).  The fan in of a product is every
    axis but the last (a stacked leaf's first axis aside)."""
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
            out[path] = np.full(shape, layer_scale, np.float32)
        else:
            raise ValueError(f"no fill rule for the leaf {path}")
    return out


def rotate_heads(flat: Mapping[str, np.ndarray], layer: int, num_heads: int,
                 kind: str = "global") -> dict[str, np.ndarray]:
    """The broken control: ``flat`` with the query heads of ``kind``
    ("global" or "local") layer ``layer`` rotated by one head (head h takes
    head h - 1's columns of ``q_up``), which moves every logit of that
    layer's attention."""
    out = dict(flat)
    key = f"transformer/{kind}/attention/q_up/w"
    w = np.array(flat[key])
    d = w.shape[-1]
    heads = w[layer].reshape(w.shape[1], num_heads, d // num_heads)
    w[layer] = np.roll(heads, 1, axis=1).reshape(w.shape[1], d)
    out[key] = w
    return out


def rotate_every_head(flat: Mapping[str, np.ndarray], num_layers: int,
                      num_heads: int) -> dict[str, np.ndarray]:
    """:func:`rotate_heads` in every local and global layer: the fault of an
    attention kernel that reads the wrong head's queries.  At layer scale 1
    it moves the logits by ~0.29 of the largest, where one global layer's
    rotation moves them by ~0.03, inside bf16's own spread."""
    for layer in range(num_layers):
        for kind in ("local", "global"):
            flat = rotate_heads(flat, layer, num_heads, kind)
    return dict(flat)


def reverse_taps(flat: Mapping[str, np.ndarray], stage: int = 5) -> dict[str, np.ndarray]:
    """The second broken control: ``flat`` with the 7 depthwise taps of
    every block of ConvNeXt stage ``stage`` in reverse order, the fault of
    a conv that runs its taps the wrong way round."""
    out = dict(flat)
    key = f"cnn/stages/{stage}/blocks/depth_conv/w"  # (depth, taps, 1, C)
    out[key] = np.ascontiguousarray(np.asarray(flat[key])[:, ::-1])
    return out


def digest_indices(shapes: Mapping[str, tuple[int, ...]],
                   seed: int = DIGEST_SEED) -> dict[str, np.ndarray]:
    """The flat indices a gradient digest samples in each leaf: in sorted
    path order, DIGEST_SAMPLES distinct ones drawn from one generator, or
    every index of a leaf that has no more."""
    rng = np.random.default_rng(seed)
    out = {}
    for path in sorted(shapes):
        size = math.prod(shapes[path])
        out[path] = (np.arange(size) if size <= DIGEST_SAMPLES
                     else np.sort(rng.choice(size, DIGEST_SAMPLES, replace=False)))
    return out


def grad_digest(grads: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """A small fingerprint of the gradient leaves ``grads`` (JAX leaf path
    -> array): the values at :func:`digest_indices` (``samples``, leaf after
    leaf in sorted path order), and each leaf's largest |g| (``max``) and L2
    norm (``norm``), the two in float64."""
    paths = sorted(grads)
    idx = digest_indices({p: np.shape(grads[p]) for p in paths})
    flat = [np.asarray(grads[p], np.float32).reshape(-1) for p in paths]
    return {
        "samples": np.concatenate([g[idx[p]] for p, g in zip(paths, flat)]),
        "max": np.array([np.abs(g).max() for g in flat], np.float64),
        "norm": np.array([np.linalg.norm(g.astype(np.float64)) for g in flat]),
        "counts": np.array([idx[p].size for p in paths], np.int64),
    }


def grad_error(got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray]) -> tuple[float, int]:
    """How far the digest ``got`` lies from ``want``: over the leaves, the
    worst of the largest |sampled difference| over the leaf's largest |g|,
    and of the relative error of the leaf's norm.  Returns the error and the
    index of the leaf (in sorted path order) where it was read."""
    if not np.array_equal(got["counts"], want["counts"]):
        raise ValueError("the two digests sample other leaves")
    ends = np.cumsum(want["counts"])
    diff = np.abs(got["samples"].astype(np.float64) - want["samples"])
    worst, where = 0.0, 0
    for i, (lo, hi) in enumerate(zip(ends - want["counts"], ends)):
        sampled = diff[lo:hi].max() / want["max"][i]
        norm = abs(got["norm"][i] - want["norm"][i]) / want["norm"][i]
        if max(sampled, norm) > worst:
            worst, where = max(sampled, norm), i
    return float(worst), where


def golden_digest(golden: Mapping[str, np.ndarray], name: str) -> dict[str, np.ndarray]:
    """The gradient digest of dtype ``name`` ("f32", "bf16") in a blocks
    golden file, as :func:`grad_digest` returns it."""
    return {k: np.asarray(golden[f"grads_{name}_{k}"])
            for k in ("samples", "max", "norm", "counts")}


def relative_error(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |difference| over the largest |want|."""
    return float(np.max(np.abs(got.astype(np.float64) - want)) / np.max(np.abs(want)))
