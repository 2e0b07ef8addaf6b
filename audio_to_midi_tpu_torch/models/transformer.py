"""Transformer: GLU feed-forward, pre-LN layers, alternating local/global
attention, and the stack as a loop over pairs.

Counterpart of ``audio_to_midi_tpu/models/transformer.py`` (its scan over
stacked weights becomes an ``nn.ModuleList`` walked in Python).  As there,
``attention_impl="pallas_pair"`` runs each pair as kernel 17 and
``"pallas_fused"`` each attention sublayer as kernel 18 with the plain GLU
FFN between them (``ops/fused_layer_kernels``), where ``_pair_kernel_applicable``
takes the stack: no dropout, 3-D input, f32 or bf16, a geometry
``pair_supported`` takes.  The stack is then padded once by the local
padding, every pair runs in padded coordinates (rows outside the sequence
stay zero) and the result is cropped at the end.  Both are
``autograd.Function``s whose backward runs autograd through the plain
formulation with ``attention_impl="xla"`` -- crop, layer, re-pad -- as the
JAX ``custom_vjp``s do.  ``transformer_remat`` selects nothing here.

Dropout: with ``enable_dropout`` and ``cfg.transformer_dropout_rate`` above
0, every layer drops attention weights (``models/attention.py``) and the
output of its feed-forward block, all from one ``torch.Generator`` on the
activations' device, which is drawn from in the order the layers run.  The
JAX package splits a key down the same tree; no contract binds the streams.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops import fused_layer_kernels as flk
from ..parallel.tp import TensorParallel, copy_to_model, reduce_from_model
from . import nn as a2m_nn
from .attention import SelfAttention, _local_padding, local_self_attention, self_attention
from .rope import RopeFreqs


class FeedForward(nn.Module):
    """GLU feed-forward.  ``tp``: set by ``parallel.tp.shard_params_tp`` when
    the hidden units are sharded over the model ranks (``in_proj`` holds
    the gate and value columns of this rank's units, ``out_proj`` their
    rows)."""

    tp: TensorParallel | None = None

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


def feed_forward(
    x: torch.Tensor, p: FeedForward, *, dropout_rate: float = 0.0,
    generator: torch.Generator | None = None, enable_dropout: bool = False,
) -> torch.Tensor:
    """GLU: Linear D->2*inter, split, gelu(x1) * x2, Linear inter->D, dropout.
    Under TP: this rank's hidden units, the out-projection's partial
    products summed over the model ranks, then its bias and the dropout on
    the replicated output."""
    if p.tp is not None:
        h = a2m_nn.linear(copy_to_model(x, p.tp), p.in_proj.w, p.in_proj.b)
        x1, x2 = torch.chunk(h, 2, dim=-1)
        out = reduce_from_model(a2m_nn.linear(a2m_nn.gelu(x1) * x2, p.out_proj.w), p.tp)
        out = out + p.out_proj.b.to(out.dtype)
        return a2m_nn.dropout(out, dropout_rate, generator, enable_dropout)
    h = a2m_nn.linear(x, p.in_proj.w, p.in_proj.b)
    x1, x2 = torch.chunk(h, 2, dim=-1)
    out = a2m_nn.linear(a2m_nn.gelu(x1) * x2, p.out_proj.w, p.out_proj.b)
    return a2m_nn.dropout(out, dropout_rate, generator, enable_dropout)


def transformer_layer(
    x: torch.Tensor, p: TransformerLayer, rope: RopeFreqs, cfg: ModelConfig, *, local: bool,
    generator: torch.Generator | None = None, enable_dropout: bool = False,
) -> torch.Tensor:
    """Pre-LN attention + residual, pre-LN GLU FFN + residual.  x: (B, S, D)."""
    normed = a2m_nn.layer_norm(x, p.attention_norm.scale, p.attention_norm.bias)
    attend = local_self_attention if local else self_attention
    h = x + attend(normed, p.attention, rope, cfg, generator=generator,
                   enable_dropout=enable_dropout)
    normed_h = a2m_nn.layer_norm(h, p.ff_norm.scale, p.ff_norm.bias)
    return h + feed_forward(normed_h, p.ff, dropout_rate=cfg.transformer_dropout_rate,
                            generator=generator, enable_dropout=enable_dropout)


def alternating_layer(
    x: torch.Tensor, p: AlternatingLayer, rope: RopeFreqs, cfg: ModelConfig, *,
    generator: torch.Generator | None = None, enable_dropout: bool = False,
) -> torch.Tensor:
    x = transformer_layer(x, p.get_submodule("local"), rope, cfg, local=True,
                          generator=generator, enable_dropout=enable_dropout)
    return transformer_layer(x, p.get_submodule("global"), rope, cfg, local=False,
                             generator=generator, enable_dropout=enable_dropout)


# ---------------------------------------------------------------------------
# The fused pair (kernel 17) and sublayer (kernel 18) paths
# ---------------------------------------------------------------------------


def _pair_rope_tables(rope: RopeFreqs, cfg: ModelConfig, p_len: int, pad_l: int):
    """The kernels' RoPE tables, one row per padded row: phase A of the
    two-phase local attention at position ``r mod window``, phase B at
    ``(r - stride) mod window``, and the global positions counted from row
    pad_l (cos 1, sin 0 before it)."""
    window = cfg.local_context_window
    reps = -(-p_len // window)
    cos_a = rope.cos[:window].repeat(reps, 1)[:p_len]
    sin_a = rope.sin[:window].repeat(reps, 1)[:p_len]
    cos_b = torch.roll(cos_a, window // 2, dims=0)
    sin_b = torch.roll(sin_a, window // 2, dims=0)
    half = rope.cos.shape[1:]
    cos_g = torch.cat([rope.cos.new_ones((pad_l, *half)), rope.cos])[:p_len]
    sin_g = torch.cat([rope.sin.new_zeros((pad_l, *half)), rope.sin])[:p_len]
    return tuple(t.contiguous() for t in (cos_a, sin_a, cos_b, sin_b, cos_g, sin_g))


def _pair_kernel_applicable(cfg: ModelConfig, x: torch.Tensor, enable_dropout: bool) -> bool:
    """The JAX package's gate of kernels 17 and 18; dropout only blocks them
    when the rate is above 0."""
    if (cfg.attention_impl not in ("pallas_pair", "pallas_fused")
            or (enable_dropout and cfg.transformer_dropout_rate > 0)
            or x.dim() != 3 or x.dtype == torch.float16):
        return False
    s = x.shape[1]
    pad_l, pad_r = _local_padding(s, cfg.local_context_window)
    return (
        x.shape[-1] == cfg.transformer_hidden_dim
        and cfg.attention_size * cfg.num_transformer_heads == cfg.transformer_hidden_dim
        and flk.pair_supported(s + pad_l + pad_r, cfg.transformer_hidden_dim,
                               cfg.num_transformer_heads, cfg.local_context_window)
    )


def _crop(xp: torch.Tensor, valid_len: int, pad_l: int) -> torch.Tensor:
    return xp[:, pad_l:pad_l + valid_len]


def _repad(x: torch.Tensor, p_len: int, pad_l: int) -> torch.Tensor:
    return F.pad(x, (0, 0, pad_l, p_len - pad_l - x.shape[1]))


def _pair_plain(xp, pair, rope, cfg: ModelConfig, valid_len: int, pad_l: int):
    """Crop -> the pair on the plain (``"xla"``) path -> re-pad."""
    xla_cfg = dataclasses.replace(cfg, attention_impl="xla")
    y = alternating_layer(_crop(xp, valid_len, pad_l), pair, rope, xla_cfg)
    return _repad(y, xp.shape[1], pad_l)


def _sublayer_plain(xp, layer, rope, cfg: ModelConfig, valid_len: int, pad_l: int, local: bool):
    """Crop -> pre-LN attention + residual on the plain path -> re-pad."""
    xla_cfg = dataclasses.replace(cfg, attention_impl="xla")
    x = _crop(xp, valid_len, pad_l)
    normed = a2m_nn.layer_norm(x, layer.attention_norm.scale, layer.attention_norm.bias)
    attend = local_self_attention if local else self_attention
    return _repad(x + attend(normed, layer.attention, rope, xla_cfg), xp.shape[1], pad_l)


class _FusedFunction(torch.autograd.Function):
    """``kernel(xp)`` forward, differentiated by autograd through
    ``plain(xp)`` from the saved input.  ``params``: the module parameters
    both read; their gradients come back in their own dtype, through the
    casts the plain path applies."""

    @staticmethod
    def forward(ctx, xp, kernel, plain, *params):
        ctx.save_for_backward(xp)
        ctx.plain, ctx.params = plain, params
        return kernel(xp)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (xp,) = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0], *ctx.needs_input_grad[3:])
        leaf = xp.detach().requires_grad_(needs[0])
        inputs = [t for t, need in zip((leaf, *ctx.params), needs) if need]
        with torch.enable_grad():
            out = ctx.plain(leaf)
        grads = iter(torch.autograd.grad(out, inputs, g))
        dx, *dparams = (next(grads) if need else None for need in needs)
        return (dx, None, None, *dparams)


def _fused_pair(xp, pair: AlternatingLayer, rope: RopeFreqs, tables, cfg: ModelConfig,
                valid_len: int, pad_l: int) -> torch.Tensor:
    """One pair as kernel 17 on xp (B, P, D) in padded coordinates; tables:
    :func:`_pair_rope_tables`."""
    kernel = lambda x: flk.transformer_pair(
        x, flk.pair_weights(pair, x.dtype), tables, num_heads=cfg.num_transformer_heads,
        valid_len=valid_len, pad_l=pad_l, window=cfg.local_context_window)
    plain = lambda x: _pair_plain(x, pair, rope, cfg, valid_len, pad_l)
    return _FusedFunction.apply(xp, kernel, plain, *pair.parameters())


def _fused_sub(xp, layer: TransformerLayer, rope: RopeFreqs, tables, cfg: ModelConfig,
               valid_len: int, pad_l: int, local: bool) -> torch.Tensor:
    """One attention sublayer as kernel 18 on xp (B, P, D) in padded
    coordinates; tables: :func:`_pair_rope_tables`."""
    geometry = dict(num_heads=cfg.num_transformer_heads, valid_len=valid_len, pad_l=pad_l)
    if local:
        kernel = lambda x: flk.fused_local_sublayer(
            x, flk.sublayer_weights(layer, x.dtype), tables[:4],
            window=cfg.local_context_window, **geometry)
    else:
        kernel = lambda x: flk.fused_global_sublayer(
            x, flk.sublayer_weights(layer, x.dtype), tables[4:], **geometry)
    plain = lambda x: _sublayer_plain(x, layer, rope, cfg, valid_len, pad_l, local)
    params = (*layer.attention_norm.parameters(), *layer.attention.parameters())
    return _FusedFunction.apply(xp, kernel, plain, *params)


def _fused_stack(x: torch.Tensor, stack: TransformerStack, rope: RopeFreqs,
                 cfg: ModelConfig) -> torch.Tensor:
    """The stack through kernel 17 or 18, in padded coordinates."""
    s = x.shape[1]
    pad_l, pad_r = _local_padding(s, cfg.local_context_window)
    h = F.pad(x, (0, 0, pad_l, pad_r))
    tables = _pair_rope_tables(rope, cfg, h.shape[1], pad_l)
    if cfg.attention_impl == "pallas_fused":
        # The FFNs stay plain, with the padding rows' branch re-zeroed.
        rows = torch.arange(h.shape[1], device=x.device)
        row_valid = ((rows >= pad_l) & (rows < pad_l + s))[None, :, None]

        def ffn_sub(h, layer):
            normed = a2m_nn.layer_norm(h, layer.ff_norm.scale, layer.ff_norm.bias)
            r = feed_forward(normed, layer.ff)
            return h + torch.where(row_valid, r, torch.zeros_like(r))

        for pair in stack.layers:
            for side, local in (("local", True), ("global", False)):
                layer = pair.get_submodule(side)
                h = ffn_sub(_fused_sub(h, layer, rope, tables, cfg, s, pad_l, local), layer)
    else:
        for pair in stack.layers:
            h = _fused_pair(h, pair, rope, tables, cfg, s, pad_l)
    return h[:, pad_l:pad_l + s]


def transformer_stack(
    x: torch.Tensor, stack: TransformerStack, rope: RopeFreqs, cfg: ModelConfig, *,
    generator: torch.Generator | None = None, enable_dropout: bool = False,
) -> torch.Tensor:
    """x: (B, S, D) through every (local, global) pair in order.  A stack
    sharded over the model ranks takes no fused kernel (kernels 17, 18 hold
    whole weights)."""
    sharded = stack.layers[0].get_submodule("local").attention.tp is not None
    if not sharded and _pair_kernel_applicable(cfg, x, enable_dropout):
        return _fused_stack(x, stack, rope, cfg)
    for layer in stack.layers:
        x = alternating_layer(x, layer, rope, cfg, generator=generator,
                              enable_dropout=enable_dropout)
    return x
