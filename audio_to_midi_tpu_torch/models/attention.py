"""Compressed-KV (MLA-style) self-attention and sliding-window local attention.

Counterpart of ``audio_to_midi_tpu/models/attention.py``:
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
the flattened-window route (``padded % 16``) mirrors the JAX package.  The
kernel wrappers are differentiable (their backward is a kernel too); the
plain versions are differentiated by ordinary autograd.
``"pallas_rw"`` routes as ``"pallas"`` except on the dropout-free two-phase
route, where it takes the reduced-width two-phase kernel 6
(``ak.local_two_phase_rw``, per-window 16 x 16 logit tiles, phase B as phase
A on rows rolled by 8) with kernel 7 as its backward, as the JAX package
does.
``"pallas_block"`` runs the whole block (projections, RoPE, attention,
average, out-proj) as kernel 11 (``ops/fused_layer_kernels``) where the JAX
package does: no dropout, 3-D input, f32 or bf16; its backward is autograd
through the kernel's plain formulation.  ``"pallas_fused"`` and
``"pallas_pair"`` take their kernels in ``models/transformer.py``.  Wherever
their own kernel is not taken, the three run the plain cores, as the JAX
package sends them to its einsum route.

f16 takes no kernel, whatever ``attention_impl`` says: the JAX package gates
every kernel route with ``mosaic_dtype_ok`` (Mosaic has no f16), so under
the f16 loss-scaling policy its attention runs the einsum route -- logits in
the dtype, fp32 softmax cast back, the exact-rate dropout -- and its local
layers the windowed (B, W, 16, 16) route.  The port does the same.

Attention-weight dropout (``enable_dropout`` with a rate above 0) follows the
JAX package's routing.  With ``"pallas"`` or ``"pallas_rw"``, where the rate
quantizes to a uint8 threshold inside (0, 256) -- 0.1 -> 26/256 -- and the
geometry suits the kernel (global: S >= 128; local: the two-phase route), one
(2,) int32 seed is drawn from the generator on the activations' device and
the seeded kernel applies the mask it stands for; ``A2M_PRNG_DROPOUT=0`` in
the environment selects, as in the JAX package, the precomputed-bits kernels
instead, fed the same bytes.  Everything else -- every other
``attention_impl``, f16, a rate too small or too large to quantize, short
sequences, the windowed local route -- computes the weights in plain
PyTorch and drops them at the exact rate with ``nn.dropout`` (keep 0.9,
scale 1/0.9 at rate 0.1), as the JAX einsum route does; the local layers
take the windowed (B, W, 16, 16) route for it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops import attention_kernels as ak
from ..ops import fused_layer_kernels as flk
from ..parallel.tp import TensorParallel, copy_to_model, reduce_from_model
from . import nn as a2m_nn
from .rope import RopeFreqs, apply_rope_halves, rope_with


class SelfAttention(nn.Module):
    """Bias-free projections; q_up/k_up columns in RoPE-halves order.
    ``tp``: set by ``parallel.tp.shard_params_tp`` when the heads are sharded
    over the model ranks."""

    tp: TensorParallel | None = None

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


# The values that run the attention-core kernels, and those that run the
# plain cores wherever their own kernel is not taken.
KERNEL_CORE_IMPLS = ("pallas", "pallas_rw")
PLAIN_CORE_IMPLS = ("xla", "pallas_block", "pallas_fused", "pallas_pair")


def _plain_impl(cfg: ModelConfig) -> bool:
    """Whether ``cfg.attention_impl`` runs the plain cores (rather than the
    attention kernels of ``"pallas"`` and ``"pallas_rw"``)."""
    if cfg.attention_impl in KERNEL_CORE_IMPLS:
        return False
    if cfg.attention_impl in PLAIN_CORE_IMPLS:
        return True
    raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")


def _block_kernel_applicable(cfg: ModelConfig, x: torch.Tensor, dropout: bool) -> bool:
    """Where ``"pallas_block"`` takes kernel 11, as in the JAX package."""
    return (cfg.attention_impl == "pallas_block" and not dropout and x.dim() == 3
            and x.dtype != torch.float16)


def _dropout_on(cfg: ModelConfig, enable_dropout: bool,
                generator: torch.Generator | None) -> bool:
    """Dropout only gates the routes when it does something: rate 0 keeps
    the dropout-free kernels in training."""
    on = enable_dropout and cfg.transformer_dropout_rate > 0
    if on and generator is None:
        raise ValueError("dropout needs a generator when enabled")
    return on


def new_dropout_seed(generator: torch.Generator, device: torch.device,
                     tp: TensorParallel | None = None) -> torch.Tensor:
    """A fresh (2,) int32 seed for one attention call, drawn on ``device``
    (the generator's): no value passes through the host.  Under TP every
    model rank draws the same and folds in its index."""
    seed = torch.randint(0, 2 ** 31 - 1, (2,), dtype=torch.int32, device=device,
                         generator=generator)
    return seed if tp is None else tp.fold_seed(seed)


def _local_heads(cfg: ModelConfig, p: SelfAttention) -> int:
    """The heads this rank computes: all, or its share under TP."""
    return cfg.num_transformer_heads // (1 if p.tp is None else p.tp.size)


def _kv_down(x: torch.Tensor, p: SelfAttention) -> torch.Tensor:
    """The compressed kv.  Under TP both it and the input of the sharded
    ``q_up`` pass ``copy_to_model``, so that the gradients of x and of
    ``kv_down`` come out whole on every model rank."""
    return copy_to_model(a2m_nn.linear(x, p.kv_down.w), p.tp)


def _out(attn: torch.Tensor, p: SelfAttention) -> torch.Tensor:
    """The bias-free out-projection; under TP the partial products summed
    over the model ranks."""
    return reduce_from_model(a2m_nn.linear(attn, p.out.w), p.tp)


def _qkv(x: torch.Tensor, p: SelfAttention, num_heads: int, rope: RopeFreqs):
    """x: (..., S, D) -> rope'd q, k and v, each (..., S, H, hd).  RoPE
    positions run over the S axis and restart at 0."""
    *lead, s, _ = x.shape
    q = a2m_nn.linear(copy_to_model(x, p.tp), p.q_up.w).reshape(*lead, s, num_heads, -1)
    q = apply_rope_halves(q, rope)
    ckv = _kv_down(x, p)
    k = a2m_nn.linear(ckv, p.k_up.w).reshape(*lead, s, num_heads, -1)
    k = apply_rope_halves(k, rope)
    v = a2m_nn.linear(ckv, p.v_up.w).reshape(*lead, s, num_heads, -1)
    return q, k, v


def _attend_einsum(q, k, v, rate: float = 0.0,
                   generator: torch.Generator | None = None,
                   tp: TensorParallel | None = None, num_heads: int = 0) -> torch.Tensor:
    """Plain attention as the JAX package's einsum route: q scaled in its
    dtype, logits in the dtype, fp32 softmax cast back, with a generator
    ``nn.dropout`` on the weights at the exact rate, weights . v in the
    dtype.  q, k, v: (..., S, H, hd); no mask (the routes that come here
    have none).  Under TP (``num_heads`` the model's) the mask of all heads
    is drawn and this rank's are taken: the single-rank mask."""
    *lead, s, h, hd = q.shape
    q = q / torch.tensor(math.sqrt(hd), dtype=q.dtype, device=q.device)
    logits = torch.einsum("...shd,...Shd->...hsS", q, k)
    weights = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
    if generator is not None and tp is not None and 0.0 < rate < 1.0:
        full = (*weights.shape[:-3], num_heads, *weights.shape[-2:])
        keep = a2m_nn.dropout_mask(full, 1.0 - rate, generator, weights.device)
        mask = keep[..., tp.head_slice(num_heads), :, :]
        weights = torch.where(mask, weights / (1.0 - rate), torch.zeros_like(weights))
    elif generator is not None:
        weights = a2m_nn.dropout(weights, rate, generator, True)
    return torch.einsum("...hsS,...Shd->...shd", weights, v).reshape(*lead, s, h * hd)


def _attend(q, k, v, cfg: ModelConfig, *, block: int = 0,
            generator: torch.Generator | None = None, dropout: bool = False,
            tp: TensorParallel | None = None) -> torch.Tensor:
    """q, k, v: (..., S, H, hd) -> (..., S, H*hd).  The (..., S, H, hd) ->
    (G, S, H*hd) reshape is free: no transposes around the core."""
    *lead, s, h, hd = q.shape
    f16 = q.dtype == torch.float16
    plain = _plain_impl(cfg)
    rate = cfg.transformer_dropout_rate
    threshold = ak.dropout_threshold(rate)
    # f16 (the JAX package's einsum route for every dtype Mosaic refuses),
    # and under dropout the plain routes, sequences too short for the dropout
    # kernel (the windowed route's S = 16) and rates that quantize to
    # keep-all or keep-nothing: the einsum route, at the exact rate.  The
    # flattened route's block mask never comes here: f16 and dropout take
    # the windowed route instead.
    if f16 or (dropout and (plain or not (s >= 128 and 0 < threshold < 256))):
        return _attend_einsum(q, k, v, rate, generator if dropout else None, tp,
                              cfg.num_transformer_heads)
    fq, fk, fv = (t.reshape(-1, s, h * hd) for t in (q, k, v))
    if not dropout:
        core = ak.global_attention_plain if plain else ak.global_attention
        out = core(fq, fk, fv, h, block)
    else:
        seed = new_dropout_seed(generator, q.device, tp)
        if ak.prng_dropout_available():
            out = ak.global_attention_dropout(fq, fk, fv, seed, h, block,
                                              threshold=threshold)
        else:
            bits = ak.philox_bits(seed, fq.shape[0], h, s)
            out = ak.global_attention_dropout_bits(fq, fk, fv, bits, h, block,
                                                   threshold=threshold)
    return out.reshape(*lead, s, h * hd)


def _rope_tables(rope: RopeFreqs, n: int, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, hd/2) cos/sin tables: absolute positions (global) or positions
    restarting every ``window`` rows (windowed rows)."""
    if window > 0:
        reps = -(-n // window)
        return (rope.cos[:window].repeat(reps, 1)[:n].contiguous(),
                rope.sin[:window].repeat(reps, 1)[:n].contiguous())
    return rope.cos[:n], rope.sin[:n]


class _AttentionBlock(torch.autograd.Function):
    """Kernel 11 forward (``flk.attention_block``); the backward is autograd
    through its plain formulation on the saved inputs, as the JAX package's
    ``_layer_bwd`` differentiates ``_attention_layer_reference``.  The RoPE
    tables get no gradient."""

    @staticmethod
    def forward(ctx, x, wq, wkv, wk, wv, wo, cos, sin, num_heads, valid_len, window):
        ctx.save_for_backward(x, wq, wkv, wk, wv, wo, cos, sin)
        ctx.geometry = (num_heads, valid_len, window)
        return flk.attention_block(x, wq, wkv, wk, wv, wo, cos, sin, *ctx.geometry)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *inputs, cos, sin = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in inputs]
        with torch.enable_grad():
            out = flk.attention_block_plain(*leaves, cos, sin, *ctx.geometry)
        return (*torch.autograd.grad(out, leaves, g), None, None, None, None, None)


def _attention_block(x: torch.Tensor, p: SelfAttention, rope: RopeFreqs, cfg: ModelConfig,
                     valid_len: int, window: int) -> torch.Tensor:
    """The whole attention block as kernel 11.  x: (B, P, D) pre-normed (P
    the local padded length when window > 0)."""
    p_len = x.shape[1]
    rows = (p_len // (window // 2) - 1) * window if window > 0 else p_len
    cos, sin = _rope_tables(rope, rows, window)
    w = lambda lin: lin.w.to(x.dtype)
    return _AttentionBlock.apply(x.contiguous(), w(p.q_up), w(p.kv_down), w(p.k_up), w(p.v_up),
                                 w(p.out), cos, sin, cfg.num_transformer_heads, valid_len, window)


def self_attention(
    x: torch.Tensor, p: SelfAttention, rope: RopeFreqs, cfg: ModelConfig, *,
    generator: torch.Generator | None = None, enable_dropout: bool = False,
) -> torch.Tensor:
    """Global compressed-KV attention.  x: (..., S, D) -> same shape."""
    dropout = _dropout_on(cfg, enable_dropout, generator)
    if p.tp is None and _block_kernel_applicable(cfg, x, dropout):
        return _attention_block(x, p, rope, cfg, valid_len=x.shape[1], window=0)
    q, k, v = _qkv(x, p, _local_heads(cfg, p), rope)
    attn = _attend(q, k, v, cfg, generator=generator, dropout=dropout, tp=p.tp)
    return _out(attn, p)


def _local_padding(seq_len: int, window: int) -> tuple[int, int]:
    """Reference model.py:421-428 padding rule."""
    stride = window // 2
    required = stride - (seq_len - window) % stride
    if required == stride:
        return 0, 0
    return required // 2, required - required // 2


def local_self_attention(
    x: torch.Tensor, p: SelfAttention, rope: RopeFreqs, cfg: ModelConfig, *,
    generator: torch.Generator | None = None, enable_dropout: bool = False,
) -> torch.Tensor:
    """Sliding-window attention with overlap averaging.  x: (B, S, D) -> same."""
    plain = _plain_impl(cfg)
    f16 = x.dtype == torch.float16
    dropout = _dropout_on(cfg, enable_dropout, generator)
    threshold = ak.dropout_threshold(cfg.transformer_dropout_rate)
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
    heads, hd = _local_heads(cfg, p), cfg.attention_size

    if p.tp is None and _block_kernel_applicable(cfg, x, dropout):
        # Kernel 11 on the padded rows; the crop reproduces the reference's
        # padded-coordinate quirk.
        return _attention_block(xp, p, rope, cfg, valid_len=padded, window=window)[:, :seq_len, :]

    if not f16 and padded % window == 0 and padded % 16 == 0 and (
            not dropout or (not plain and 0 < threshold < 256)):
        # Two-phase route: q/k/v projected once on the padded rows, RoPE'd
        # with per-phase tables whose positions restart every window (phase
        # B's windows start `stride` rows later), one core for both phases
        # and the overlap average.  With dropout (the kernels only) each
        # original window lies in exactly one phase, so per-window weights
        # are dropped independently.
        q = a2m_nn.linear(copy_to_model(xp, p.tp), p.q_up.w).reshape(b, padded, heads, hd)
        ckv = _kv_down(xp, p)
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
        inputs = (flat(qa), flat(ka), flat(qb), flat(kb), v)
        if not dropout:
            if plain:
                core = ak.local_two_phase_plain
            elif cfg.attention_impl == "pallas_rw":
                core = ak.local_two_phase_rw
            else:
                core = ak.local_two_phase
            out = core(*inputs, heads, window)
        else:
            seed = new_dropout_seed(generator, x.device, p.tp)
            if ak.prng_dropout_available():
                out = ak.local_two_phase_dropout(*inputs, seed, heads, window,
                                                 threshold=threshold)
            else:
                bits = ak.two_phase_planes(ak.philox_bits(seed, b, 2 * heads, padded), heads)
                out = ak.local_two_phase_dropout_bits(*inputs, *bits, heads, window,
                                                      threshold=threshold)
        # Crop the padded-coordinate average to the first seq_len rows (the
        # reference quirk); the bias-free out-proj commutes with the crop.
        return _out(out[:, :seq_len, :], p)

    # Windowed routes: (B, W, window, D), window w covering padded rows
    # [w*stride, w*stride + window), built from two interleaved
    # non-overlapping reshapes.
    blocks = xp.reshape(b, num_blocks, stride, d)
    windows = torch.cat([blocks[:, :-1], blocks[:, 1:]], dim=2)
    q, k, v = _qkv(windows, p, heads, rope)
    if dropout or f16:
        # (B, W, 16, 16) weights per head in plain PyTorch (dropped at the
        # exact rate), as the JAX einsum route: with dropout on, or in f16,
        # the flattened route is not taken.
        out_w = _attend(q, k, v, cfg, generator=generator, dropout=dropout, tp=p.tp)
    else:
        # Flattened: the (windows, window) axes become one sequence and a
        # block-diagonal mask realizes the per-window softmax.
        flat = lambda t: t.reshape(b, num_windows * window, heads, hd)
        out_w = _attend(flat(q), flat(k), flat(v), cfg, block=window)
        out_w = out_w.reshape(b, num_windows, window, heads * hd)
    out_w = _out(out_w, p)

    # Overlap-average in padded coordinates, then crop to seq_len rows.
    first = out_w[:, :, :stride, :]   # window k's contribution to block k
    second = out_w[:, :, stride:, :]  # window k's contribution to block k+1
    zeros = torch.zeros((b, 1, stride, d), dtype=out_w.dtype, device=out_w.device)
    block_sum = torch.cat([first, zeros], dim=1) + torch.cat([zeros, second], dim=1)
    count = torch.ones(num_blocks, dtype=x.dtype, device=x.device)
    count[1:-1] = 2.0
    avg = block_sum / count[None, :, None, None]
    return avg.reshape(b, padded, d)[:, :seq_len, :]
