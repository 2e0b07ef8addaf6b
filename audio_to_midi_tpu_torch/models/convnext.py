"""ConvNeXt-style 1-D audio encoder.

Counterpart of ``audio_to_midi_tpu/models/convnext.py``, in the plain
formulation for every stage (the JAX package's packed rewrite of the small
stages computes the same function and is not carried over):
  * stem: k=s=5 conv 2 -> dims[0] as a patch matmul, then LayerNorm;
  * downsample: LayerNorm, then a k=s=2 conv doubling channels as a patch
    matmul;
  * block: depthwise k=7 SAME -> LayerNorm -> 1x1 up -> GELU -> 1x1 down ->
    layer-scale gamma -> + residual.
Stochastic depth (a whole block's branch dropped per sample, at rates that
ramp from 0 to ``sdd_rate`` over the blocks) runs only with
``enable_dropout`` and ``enable_cnn_stochastic_depth``; the reference's
configuration leaves it off.

A stage's blocks take one of three routes, chosen as the JAX package's
``cnn_forward`` chooses (:func:`stage_route`): with
``cnn_impl="pallas_stage"`` the fused stage forward
(``ops/convnext_kernels.fused_convnext_stage``, kernel 19); else, with
``cnn_bwd_kernel`` and ``cnn_impl`` "pallas" or "pallas_stage", the plain
block loop forward with the fused stage backward
(``ops/convnext_kernels.stage_blocks_fused_bwd``, kernel 20) -- stages 5 and
6 of the default configuration; else the block loop under ordinary autograd,
the counterpart of the JAX package's scanned backward.  ``cnn_impl="xla"``
takes the block loop everywhere.  ``cnn_remat`` selects nothing: the fused
backward saves every block's input, autograd every block's activations.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import convnext_kernels
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


def sdd_schedule(cfg: ModelConfig) -> list[float]:
    """Per-block stochastic-depth rates, 0 -> ``cfg.sdd_rate`` over all blocks."""
    n = sum(cfg.depths)
    return [cfg.sdd_rate * i / max(n - 1, 1) for i in range(n)]


def block(x: torch.Tensor, p: Block, *, sdd_rate: float = 0.0,
          generator: torch.Generator | None = None) -> torch.Tensor:
    """ConvNeXt block.  x: (B, L, C).  With a ``generator``, the branch is
    dropped whole for each sample that draws below ``sdd_rate``."""
    out = a2m_nn.depthwise_conv1d_same(x, p.depth_conv.w, p.depth_conv.b)
    out = a2m_nn.layer_norm(out, p.norm.scale, p.norm.bias)
    out = a2m_nn.linear(out, p.pw1.w, p.pw1.b)
    out = a2m_nn.gelu(out)
    out = a2m_nn.linear(out, p.pw2.w, p.pw2.b)
    out = p.gamma.to(out.dtype) * out
    if generator is not None:
        rand = torch.rand((x.shape[0], 1, 1), generator=generator, device=x.device)
        out = torch.where(rand < sdd_rate, torch.zeros_like(out), out)
    return out + x


def stage_route(cfg: ModelConfig, stage: int, length: int, dtype: torch.dtype,
                enable_sdd: bool = False) -> str:
    """Which code runs the blocks of ``stage`` on ``length`` rows in
    ``dtype``: "stage_fwd" (kernel 19 forward, rematerializing autograd
    backward), "stage_bwd" (block loop forward, kernel 20 backward) or
    "blocks" (the block loop under autograd).  The JAX package's
    ``cnn_forward`` decides the same way; f16 and stochastic depth take the
    block loop."""
    c, hidden, depth = cfg.dims[stage], cfg.cnn_hidden_dims[stage], cfg.depths[stage]
    if enable_sdd:
        return "blocks"
    if cfg.cnn_impl == "pallas_stage" and convnext_kernels.stage_fwd_supported(
            length, c, depth, dtype):
        return "stage_fwd"
    if (cfg.cnn_bwd_kernel and cfg.cnn_impl in ("pallas", "pallas_stage")
            and convnext_kernels.stage_bwd_supported(length, c, hidden, depth, dtype)):
        return "stage_bwd"
    return "blocks"


def cnn_forward(
    x: torch.Tensor, cnn: CNN, cfg: ModelConfig | None = None, *,
    generator: torch.Generator | None = None, enable_dropout: bool = False,
) -> torch.Tensor:
    """Full encoder.  x: (B, L_samples, 2) -> (B, frames, dims[-1]).

    Stochastic depth draws from ``generator`` (on x's device) when
    ``enable_dropout`` and ``cfg.enable_cnn_stochastic_depth`` are both set.
    Without ``cfg`` every stage takes the block loop."""
    enable_sdd = enable_dropout and cfg is not None and cfg.enable_cnn_stochastic_depth
    if enable_sdd and generator is None:
        raise ValueError("stochastic depth needs a generator when enabled")
    rates = iter(sdd_schedule(cfg)) if enable_sdd else None
    h = x
    for i, stage in enumerate(cnn.stages):
        h = stem(h, stage.down) if i == 0 else downsample(h, stage.down)
        route = "blocks" if cfg is None else stage_route(cfg, i, h.shape[1], h.dtype, enable_sdd)
        if route == "stage_fwd":
            h = convnext_kernels.fused_convnext_stage(
                h, convnext_kernels.stage_weights(stage.blocks, h.dtype))
        elif route == "stage_bwd" and torch.is_grad_enabled():
            # Serving (no gradient) keeps the block loop and stacks nothing.
            h = convnext_kernels.stage_blocks_fused_bwd(
                h, convnext_kernels.stage_weights(stage.blocks, h.dtype))
        else:
            for blk in stage.blocks:
                if enable_sdd:
                    h = block(h, blk, sdd_rate=next(rates), generator=generator)
                else:
                    h = block(h, blk)
    return a2m_nn.layer_norm(h, cnn.final_norm.scale, cnn.final_norm.bias)
