"""Transformer: GLU feed-forward, pre-LN layers, alternating local/global
attention, and the stack as a loop over pairs.

Counterpart of ``audio_to_midi_tpu/models/transformer.py`` (its scan over
stacked weights becomes an ``nn.ModuleList`` walked in Python; its fused
pair and sublayer kernels are not ported).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from . import nn as a2m_nn
from .attention import SelfAttention, local_self_attention, self_attention
from .rope import RopeFreqs


class FeedForward(nn.Module):
    def __init__(self, hidden_dim: int, intermediate_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_proj = a2m_nn.Linear(hidden_dim, 2 * intermediate_dim, generator)
        self.out_proj = a2m_nn.Linear(intermediate_dim, hidden_dim, generator)


class TransformerLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None):
        super().__init__()
        d = cfg.transformer_hidden_dim
        self.attention_norm = a2m_nn.LayerNorm(d)
        self.attention = SelfAttention(cfg, generator)
        self.ff_norm = a2m_nn.LayerNorm(d)
        self.ff = FeedForward(d, cfg.transformer_intermediate_size, generator)


class AlternatingLayer(nn.Module):
    """A local (window) layer, then a global layer.  The submodules are named
    ``local`` and ``global`` as in the JAX parameter tree."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.add_module("local", TransformerLayer(cfg, generator))
        self.add_module("global", TransformerLayer(cfg, generator))


class TransformerStack(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.layers = nn.ModuleList(
            AlternatingLayer(cfg, generator) for _ in range(cfg.num_transformer_layers)
        )


def feed_forward(x: torch.Tensor, p: FeedForward) -> torch.Tensor:
    """GLU: Linear D->2*inter, split, gelu(x1) * x2, Linear inter->D."""
    h = a2m_nn.linear(x, p.in_proj.w, p.in_proj.b)
    x1, x2 = torch.chunk(h, 2, dim=-1)
    return a2m_nn.linear(a2m_nn.gelu(x1) * x2, p.out_proj.w, p.out_proj.b)


def transformer_layer(
    x: torch.Tensor, p: TransformerLayer, rope: RopeFreqs, cfg: ModelConfig, *, local: bool
) -> torch.Tensor:
    """Pre-LN attention + residual, pre-LN GLU FFN + residual.  x: (B, S, D)."""
    normed = a2m_nn.layer_norm(x, p.attention_norm.scale, p.attention_norm.bias)
    attend = local_self_attention if local else self_attention
    h = x + attend(normed, p.attention, rope, cfg)
    normed_h = a2m_nn.layer_norm(h, p.ff_norm.scale, p.ff_norm.bias)
    return h + feed_forward(normed_h, p.ff)


def alternating_layer(
    x: torch.Tensor, p: AlternatingLayer, rope: RopeFreqs, cfg: ModelConfig
) -> torch.Tensor:
    x = transformer_layer(x, p.get_submodule("local"), rope, cfg, local=True)
    return transformer_layer(x, p.get_submodule("global"), rope, cfg, local=False)


def transformer_stack(
    x: torch.Tensor, stack: TransformerStack, rope: RopeFreqs, cfg: ModelConfig
) -> torch.Tensor:
    """x: (B, S, D) through every (local, global) pair in order."""
    for layer in stack.layers:
        x = alternating_layer(x, layer, rope, cfg)
    return x
