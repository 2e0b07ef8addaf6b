"""Custom init surgery: the reference's (disabled) ``init_model``
(train.py:573-644), behind ``TrainConfig.use_custom_init``.

Counterpart of ``audio_to_midi_tpu/train/init_surgery.py``.  It re-draws
the attention projection weights and every CNN conv weight from
N(0, 0.2), the CNN conv biases from N(0, 0.01), and zeroes the attention
projection biases.  Targets, by a leaf's parent and field:
  * the attention projections ``q_up``, ``kv_down``, ``k_up``, ``v_up``
    (the out-projection is not touched); the port's are bias-free, so only
    their weights change;
  * every conv: the stem and downsamples (``conv``), the depthwise convs and
    the two pointwise convs of each ConvNeXt block (``pw1``, ``pw2``).

It works on the flat JAX layout (``convert.state_dict_to_jax``), a stacked
``(depth, ...)`` or ``(layers, ...)`` leaf drawn whole, and walks the leaves
in ``jax.tree.leaves`` order.  The q/k weights are stored in the RoPE halves
layout, so their fresh draws get the same column permutation.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from ..convert import jax_leaf_order, jax_to_state_dict, state_dict_to_jax
from ..models.rope import rope_permutation

_ATTN_KEYS = ("q_up", "kv_down", "k_up", "v_up")
_CONV_KEYS = ("conv", "depth_conv", "pw1", "pw2")

_HEAD_WEIGHT_STD = 0.2
_CNN_WEIGHT_STD = 0.2
_CNN_BIAS_STD = 0.01

# normal(leaf index in jax.tree.leaves order, shape) -> standard normal draws.
Normal = Callable[[int, tuple[int, ...]], np.ndarray]


def torch_normal(generator: torch.Generator) -> Normal:
    """Draws from ``generator``, one leaf after another."""
    return lambda _index, shape: torch.randn(shape, generator=generator,
                                             dtype=torch.float32).numpy()


def apply_init_surgery(flat: Mapping[str, np.ndarray], num_heads: int,
                       normal: Normal | None = None) -> dict[str, np.ndarray]:
    """The surgery on one member's flat JAX parameter dict; returns a new
    dict.  ``normal`` gives the standard normal draws of a targeted leaf
    (default: a fresh ``torch.Generator``'s); JAX draws leaf i from the i-th
    of its split keys, which ``normal`` receives as its first argument."""
    if normal is None:
        normal = torch_normal(torch.Generator())
    out = {}
    for i, path in enumerate(jax_leaf_order(flat)):
        leaf = np.asarray(flat[path])
        out[path] = leaf
        names = path.split("/")
        if len(names) < 2:
            continue
        parent, field = names[-2], names[-1]
        if parent in _ATTN_KEYS and field == "w":
            w = np.asarray(normal(i, leaf.shape), leaf.dtype) * _HEAD_WEIGHT_STD
            if parent in ("q_up", "k_up"):
                *lead, in_dim, out_dim = w.shape
                perm = rope_permutation(out_dim // num_heads)
                w = w.reshape(*lead, in_dim, num_heads, out_dim // num_heads)
                w = w[..., perm].reshape(*lead, in_dim, out_dim)
            out[path] = w
        elif parent in _ATTN_KEYS and field == "b":
            out[path] = np.zeros_like(leaf)
        elif parent in _CONV_KEYS and field == "w":
            out[path] = np.asarray(normal(i, leaf.shape), leaf.dtype) * _CNN_WEIGHT_STD
        elif parent in _CONV_KEYS and field == "b":
            out[path] = np.asarray(normal(i, leaf.shape), leaf.dtype) * _CNN_BIAS_STD
    return out


@torch.no_grad()
def apply_init_surgery_(model: torch.nn.Module, num_heads: int,
                        generator: torch.Generator) -> torch.nn.Module:
    """The surgery on one ``Model``, its parameters overwritten in place,
    the draws from ``generator``."""
    flat = apply_init_surgery(state_dict_to_jax(model.state_dict()), num_heads,
                              torch_normal(generator))
    model.load_state_dict(jax_to_state_dict(flat), strict=True)
    return model
