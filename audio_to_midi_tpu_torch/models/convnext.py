"""ConvNeXt-style 1-D audio encoder.

Counterpart of ``audio_to_midi_tpu/models/convnext.py``, in the plain
formulation for every stage (the JAX package's packed rewrite of the small
stages computes the same function and is not carried over):
  * stem: k=s=5 conv 2 -> dims[0] as a patch matmul, then LayerNorm;
  * downsample: LayerNorm, then a k=s=2 conv doubling channels as a patch
    matmul;
  * block: depthwise k=7 SAME -> LayerNorm -> 1x1 up -> GELU -> 1x1 down ->
    layer-scale gamma -> + residual.
Stochastic depth is inert at serving and is not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from . import nn as a2m_nn


class Stem(nn.Module):
    def __init__(self, out_channels: int, generator: torch.Generator | None,
                 kernel_size: int = 5):
        super().__init__()
        self.conv = a2m_nn.Conv1d(2, out_channels, kernel_size, generator)
        self.norm = a2m_nn.LayerNorm(out_channels)


class Downsample(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 generator: torch.Generator | None):
        super().__init__()
        self.conv = a2m_nn.Conv1d(in_channels, out_channels, 2, generator)
        self.norm = a2m_nn.LayerNorm(in_channels)


class Block(nn.Module):
    def __init__(self, channels: int, hidden_dim: int,
                 generator: torch.Generator | None, kernel_size: int = 7):
        super().__init__()
        self.depth_conv = a2m_nn.Conv1d(
            channels, channels, kernel_size, generator, groups=channels
        )
        self.norm = a2m_nn.LayerNorm(channels)
        self.pw1 = a2m_nn.Linear(channels, hidden_dim, generator)
        self.pw2 = a2m_nn.Linear(hidden_dim, channels, generator)
        self.gamma = nn.Parameter(torch.full((channels,), 1e-6))


class Stage(nn.Module):
    def __init__(self, down: nn.Module, blocks: list[Block]):
        super().__init__()
        self.down = down
        self.blocks = nn.ModuleList(blocks)


class CNN(nn.Module):
    """The 7 stages and the final LayerNorm."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None):
        super().__init__()
        stages = []
        for i, (dim, hidden, depth) in enumerate(
            zip(cfg.dims, cfg.cnn_hidden_dims, cfg.depths)
        ):
            down = (Stem(dim, generator) if i == 0
                    else Downsample(cfg.dims[i - 1], dim, generator))
            stages.append(Stage(down, [Block(dim, hidden, generator) for _ in range(depth)]))
        self.stages = nn.ModuleList(stages)
        self.final_norm = a2m_nn.LayerNorm(cfg.dims[-1])


def _patch_matmul(x: torch.Tensor, conv: a2m_nn.Conv1d) -> torch.Tensor:
    """k=s conv as a patch matmul: x (B, L, C_in) -> (B, L // k, C_out).
    Patches flatten (K, C_in) in that order, matching the WIO weight."""
    b, length, cin = x.shape
    k, _, cout = conv.w.shape
    patches = x[:, : (length // k) * k, :].reshape(b, length // k, k * cin)
    return a2m_nn.linear(patches, conv.w.reshape(k * cin, cout), conv.b)


def stem(x: torch.Tensor, p: Stem) -> torch.Tensor:
    """x: (B, L, 2) -> (B, L // 5, C)."""
    out = _patch_matmul(x, p.conv)
    return a2m_nn.layer_norm(out, p.norm.scale, p.norm.bias)


def downsample(x: torch.Tensor, p: Downsample) -> torch.Tensor:
    """LN then the k=s=2 conv: (B, L, C) -> (B, L // 2, 2C)."""
    x = a2m_nn.layer_norm(x, p.norm.scale, p.norm.bias)
    return _patch_matmul(x, p.conv)


def block(x: torch.Tensor, p: Block) -> torch.Tensor:
    """ConvNeXt block.  x: (B, L, C)."""
    out = a2m_nn.depthwise_conv1d_same(x, p.depth_conv.w, p.depth_conv.b)
    out = a2m_nn.layer_norm(out, p.norm.scale, p.norm.bias)
    out = a2m_nn.linear(out, p.pw1.w, p.pw1.b)
    out = a2m_nn.gelu(out)
    out = a2m_nn.linear(out, p.pw2.w, p.pw2.b)
    return p.gamma.to(out.dtype) * out + x


def cnn_forward(x: torch.Tensor, cnn: CNN) -> torch.Tensor:
    """Full encoder.  x: (B, L_samples, 2) -> (B, frames, dims[-1])."""
    h = x
    for i, stage in enumerate(cnn.stages):
        h = stem(h, stage.down) if i == 0 else downsample(h, stage.down)
        for blk in stage.blocks:
            h = block(h, blk)
    return a2m_nn.layer_norm(h, cnn.final_norm.scale, cnn.final_norm.bias)
