"""Compressed-KV (MLA-style) self-attention and sliding-window local attention.

Counterpart of ``audio_to_midi_tpu/models/attention.py`` for serving
(dropout is never enabled there and is not ported):
  * ``self_attention``: q_up D->H*hd, shared kv_down D->ckv with k_up/v_up
    ckv->H*hd, RoPE on q and k, attention core, bias-free out-proj;
  * ``local_self_attention``: symmetric pad so stride-8 windows of 16 cover
    every row, attention per window with RoPE positions restarting in every
    window, overlapping window outputs averaged -- in PADDED coordinates and
    cropped to the first seq_len rows, which reproduces the reference's
    shift of the local branch by pad_l frames (see the JAX module's
    docstring; checkpoints depend on it).

The attention cores run through ``ops/attention_kernels``: with
``attention_impl="pallas"`` through the kernel wrappers, with ``"xla"``
through their plain versions.  The routing between the two-phase kernel and
the flattened-window route (``padded % 16``) mirrors the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops import attention_kernels as ak
from . import nn as a2m_nn
from .rope import RopeFreqs, apply_rope_halves, rope_with


class SelfAttention(nn.Module):
    """Bias-free projections; q_up/k_up columns in RoPE-halves order."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None):
        super().__init__()
        d = cfg.transformer_hidden_dim
        width = cfg.num_transformer_heads * cfg.attention_size
        ckv = cfg.compressed_attention_kv_size
        self.q_up = a2m_nn.Linear(d, width, generator, use_bias=False)
        self.kv_down = a2m_nn.Linear(d, ckv, generator, use_bias=False)
        self.k_up = a2m_nn.Linear(ckv, width, generator, use_bias=False)
        self.v_up = a2m_nn.Linear(ckv, width, generator, use_bias=False)
        self.out = a2m_nn.Linear(width, d, generator, use_bias=False)


def _cores(cfg: ModelConfig):
    """(global core, local core) for ``cfg.attention_impl``."""
    if cfg.attention_impl == "pallas":
        return ak.global_attention, ak.local_two_phase
    if cfg.attention_impl == "xla":
        return ak.global_attention_plain, ak.local_two_phase_plain
    raise NotImplementedError(
        f"attention_impl={cfg.attention_impl!r} is not ported; use 'pallas' or 'xla'"
    )


def _qkv(x: torch.Tensor, p: SelfAttention, num_heads: int, rope: RopeFreqs):
    """x: (..., S, D) -> rope'd q, k and v, each (..., S, H, hd).  RoPE
    positions run over the S axis and restart at 0."""
    *lead, s, _ = x.shape
    q = a2m_nn.linear(x, p.q_up.w).reshape(*lead, s, num_heads, -1)
    q = apply_rope_halves(q, rope)
    ckv = a2m_nn.linear(x, p.kv_down.w)
    k = a2m_nn.linear(ckv, p.k_up.w).reshape(*lead, s, num_heads, -1)
    k = apply_rope_halves(k, rope)
    v = a2m_nn.linear(ckv, p.v_up.w).reshape(*lead, s, num_heads, -1)
    return q, k, v


def _attend(q, k, v, core, block: int = 0) -> torch.Tensor:
    """q, k, v: (..., S, H, hd) -> (..., S, H*hd).  The (..., S, H, hd) ->
    (G, S, H*hd) reshape is free: no transposes around the core."""
    *lead, s, h, hd = q.shape
    flat = lambda t: t.reshape(-1, s, h * hd)
    return core(flat(q), flat(k), flat(v), h, block).reshape(*lead, s, h * hd)


def self_attention(
    x: torch.Tensor, p: SelfAttention, rope: RopeFreqs, cfg: ModelConfig
) -> torch.Tensor:
    """Global compressed-KV attention.  x: (..., S, D) -> same shape."""
    global_core, _ = _cores(cfg)
    q, k, v = _qkv(x, p, cfg.num_transformer_heads, rope)
    return a2m_nn.linear(_attend(q, k, v, global_core), p.out.w)


def _local_padding(seq_len: int, window: int) -> tuple[int, int]:
    """Reference model.py:421-428 padding rule."""
    stride = window // 2
    required = stride - (seq_len - window) % stride
    if required == stride:
        return 0, 0
    return required // 2, required - required // 2


def local_self_attention(
    x: torch.Tensor, p: SelfAttention, rope: RopeFreqs, cfg: ModelConfig
) -> torch.Tensor:
    """Sliding-window attention with overlap averaging.  x: (B, S, D) -> same."""
    global_core, local_core = _cores(cfg)
    b, seq_len, d = x.shape
    window = cfg.local_context_window
    stride = window // 2
    if window != 2 * stride:
        raise ValueError("the overlap average needs window == 2 * stride")

    pad_l, pad_r = _local_padding(seq_len, window)
    xp = F.pad(x, (0, 0, pad_l, pad_r))
    padded = xp.shape[1]
    num_windows = (padded - window) // stride + 1
    if num_windows < 1:
        # The reference's scatter/count formulation hits 0/0 = NaN here.
        raise ValueError(
            f"local attention needs seq_len > window//2 (= {stride}); "
            f"got seq_len={seq_len} with local_context_window={window}"
        )
    num_blocks = padded // stride
    heads, hd = cfg.num_transformer_heads, cfg.attention_size

    if padded % window == 0 and padded % 16 == 0:
        # Two-phase route: q/k/v projected once on the padded rows, RoPE'd
        # with per-phase tables whose positions restart every window (phase
        # B's windows start `stride` rows later), one core for both phases
        # and the overlap average.
        q = a2m_nn.linear(xp, p.q_up.w).reshape(b, padded, heads, hd)
        ckv = a2m_nn.linear(xp, p.kv_down.w)
        k = a2m_nn.linear(ckv, p.k_up.w).reshape(b, padded, heads, hd)
        v = a2m_nn.linear(ckv, p.v_up.w)
        reps = padded // window
        cos_a = rope.cos[:window].repeat(reps, 1)
        sin_a = rope.sin[:window].repeat(reps, 1)
        cos_b = torch.roll(cos_a, stride, dims=0)
        sin_b = torch.roll(sin_a, stride, dims=0)
        flat = lambda t: t.reshape(b, padded, heads * hd)
        qa, ka = rope_with(q, cos_a, sin_a), rope_with(k, cos_a, sin_a)
        qb, kb = rope_with(q, cos_b, sin_b), rope_with(k, cos_b, sin_b)
        out = local_core(flat(qa), flat(ka), flat(qb), flat(kb), v, heads, window)
        # Crop the padded-coordinate average to the first seq_len rows (the
        # reference quirk); the bias-free out-proj commutes with the crop.
        return a2m_nn.linear(out[:, :seq_len, :], p.out.w)

    # Flattened-window route: (B, W, window, D), window w covering padded
    # rows [w*stride, w*stride + window), built from two interleaved
    # non-overlapping reshapes; the (windows, window) axes flatten into one
    # sequence and a block-diagonal mask realizes the per-window softmax.
    blocks = xp.reshape(b, num_blocks, stride, d)
    windows = torch.cat([blocks[:, :-1], blocks[:, 1:]], dim=2)
    q, k, v = _qkv(windows, p, heads, rope)
    flat = lambda t: t.reshape(b, num_windows * window, heads, hd)
    out_w = _attend(flat(q), flat(k), flat(v), global_core, block=window)
    out_w = a2m_nn.linear(out_w.reshape(b, num_windows, window, heads * hd), p.out.w)

    # Overlap-average in padded coordinates, then crop to seq_len rows.
    first = out_w[:, :, :stride, :]   # window k's contribution to block k
    second = out_w[:, :, stride:, :]  # window k's contribution to block k+1
    zeros = torch.zeros((b, 1, stride, d), dtype=out_w.dtype, device=out_w.device)
    block_sum = torch.cat([first, zeros], dim=1) + torch.cat([zeros, second], dim=1)
    count = torch.ones(num_blocks, dtype=x.dtype, device=x.device)
    count[1:-1] = 2.0
    avg = block_sum / count[None, :, None, None]
    return avg.reshape(b, padded, d)[:, :seq_len, :]
