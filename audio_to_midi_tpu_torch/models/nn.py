"""NN primitives on tensors, with the JAX package's weight layouts.

Counterpart of ``audio_to_midi_tpu/models/nn.py``:
  * activations are NWC ``(B, L, C)``;
  * a linear weight is ``(in, out)`` and applies as ``x @ w``;
  * a convolution weight is WIO ``(K, C_in / groups, C_out)``;
  * LayerNorm computes in float32 (population variance, eps 1e-5) and casts
    back to the input dtype;
  * GELU is the tanh approximation (``jax.nn.gelu``'s default);
  * dropout is inverted, at the exact rate, from an explicit
    ``torch.Generator`` -- never the global RNG state.

The ``init_*`` functions draw at the JAX package's scales (uniform
+-1/sqrt(fan_in), LayerNorm ones/zeros) from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _uniform(shape, scale: float, generator: torch.Generator | None) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * scale


def init_linear(
    in_features: int, out_features: int, generator: torch.Generator | None,
    use_bias: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(w (in, out), b (out,) or None), uniform +-1/sqrt(in)."""
    scale = 1.0 / math.sqrt(in_features)
    w = _uniform((in_features, out_features), scale, generator)
    b = _uniform((out_features,), scale, generator) if use_bias else None
    return w, b


def init_conv1d(
    in_channels: int, out_channels: int, kernel_size: int,
    generator: torch.Generator | None, groups: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(w WIO (K, C_in/groups, C_out), b (C_out,)), uniform +-1/sqrt(fan_in)."""
    fan_in = (in_channels // groups) * kernel_size
    scale = 1.0 / math.sqrt(fan_in)
    w = _uniform((kernel_size, in_channels // groups, out_channels), scale, generator)
    return w, _uniform((out_channels,), scale, generator)


def init_layer_norm(dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.ones(dim), torch.zeros(dim)


# ---------------------------------------------------------------------------
# Parameter containers (the functions below and in the model modules apply
# them; the modules hold no forward logic of their own)
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    """``w`` (in, out) and optional ``b`` (out,)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None, use_bias: bool = True):
        super().__init__()
        w, b = init_linear(in_features, out_features, generator, use_bias)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b) if b is not None else None


class Conv1d(nn.Module):
    """``w`` WIO (K, C_in/groups, C_out) and ``b`` (C_out,)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 generator: torch.Generator | None = None, groups: int = 1):
        super().__init__()
        w, b = init_conv1d(in_channels, out_channels, kernel_size, generator, groups)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        scale, bias = init_layer_norm(dim)
        self.scale = nn.Parameter(scale)
        self.bias = nn.Parameter(bias)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def depthwise_conv1d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise conv with SAME padding.  x: (B, L, C); w: WIO (K, 1, C)."""
    k = w.shape[0]
    channels = x.shape[-1]
    weight = w.to(x.dtype).permute(2, 1, 0)  # (C, 1, K), torch's OIW
    pad_lo = (k - 1) // 2                     # XLA's SAME split: extra on the right
    xt = F.pad(x.transpose(1, 2), (pad_lo, k - 1 - pad_lo))
    y = F.conv1d(xt, weight, b.to(x.dtype), groups=channels)
    return y.transpose(1, 2)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the trailing axis, computed in float32, cast back.
    Like every parameter, scale and bias are cast to x's dtype at use (the
    JAX package casts the whole tree to the compute dtype before a step)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.to(x.dtype) + bias.to(x.dtype)
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def dropout_mask(shape, keep: float, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """A Bernoulli(keep) mask of ``shape`` on ``device``, bool.  The generator
    must live on that device; its state advances."""
    return torch.empty(shape, dtype=torch.float32, device=device).bernoulli_(
        keep, generator=generator).bool()


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            enabled: bool) -> torch.Tensor:
    """Inverted dropout at the exact ``rate``: kept elements are divided by
    1 - rate, the others are 0.  A no-op when disabled or at rate 0."""
    if not enabled or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a generator when enabled")
    keep = 1.0 - rate
    if keep <= 0.0:
        return torch.zeros_like(x)
    mask = dropout_mask(x.shape, keep, generator, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))
