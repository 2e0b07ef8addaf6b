"""The fused transformer-layer kernels, with their plain versions.

Counterpart of kernels 11, 17 and 18 of the JAX package, one family of
device code (``csrc/fused_layer.cuh``, ``csrc/fused_layer_impl.cuh``): row
LayerNorm -> q / kv / k / v products -> RoPE -> masked multi-head attention
-> out-proj (-> masked residual, -> GLU FFN), the products and the global
attention on the tensor cores.

* :func:`attention_block` -- ``ops/pallas_attention.py``
  ``fused_attention_layer`` (``attention_impl="pallas_block"``): x
  pre-normed -> projections, RoPE, attention (windowed with the overlap
  average, or global), out-proj.  CUDA source: ``csrc/attention_block.cu``.
* :func:`fused_local_sublayer`, :func:`fused_global_sublayer` --
  ``ops/pallas_sublayer.py`` (``"pallas_fused"``): pre-LN, projections,
  RoPE, attention, out-proj and the masked residual of one attention
  sublayer.  CUDA source: ``csrc/fused_sublayer.cu``.
* :func:`transformer_pair` -- ``ops/pallas_pair.py``
  ``fused_transformer_pair`` (``"pallas_pair"``): a whole local + global
  pair with both GLU FFNs.  CUDA source: ``csrc/transformer_pair.cu``.

The sublayer and pair kernels work in local-padded coordinates: x is
(B, P, D) with the sequence in rows [pad_l, pad_l + S) and every other row
zero, which they keep so (every residual branch is masked).  The operands
come packed by :func:`sublayer_weights` / :func:`pair_weights` (LayerNorms
as (2, D) fp32 holding values of the compute dtype, everything else in the
compute dtype) and the RoPE tables by the callers in ``models/``.

The roundings are the TPU kernels' (``ops/pallas_pair.py:49-104``) and each
plain version repeats them: LayerNorm in fp32 cast to the dtype; every
product accumulated in fp32, its bias added in fp32, cast; RoPE in fp32 on
the cast values; q times 1/sqrt(hd) in the dtype; fp32 logits and softmax,
the weights cast to the dtype before the product with v; the overlap average
in fp32; the residual add in the dtype.

Each wrapper takes its plain version only for tensors on the CPU.  On a CUDA
tensor it launches the kernel or raises: f16 raises ``NotImplementedError``
(the models' gates send f16 to the plain formulation, as the JAX package
sends it to XLA), a geometry the kernel does not take raises ``ValueError``.
Each wrapper counts its launches in ``.launches``.  Each runs as a
``torch.library`` custom operator (``a2m::attention_block_fwd``,
``a2m::fused_sublayer_fwd``, ``a2m::transformer_pair_fwd``): the plain
version on the CPU, the kernel on the card, where the launch is counted,
and a fake implementation for ``torch.export`` (shape, dtype, strides and
the geometry checks).  None of them is differentiable by itself: the ``autograd.Function``s in ``models/`` save the
inputs and differentiate the plain formulation, as the JAX ``custom_vjp``s
do.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..models import nn as a2m_nn
from ..models.rope import rope_with
from . import cuda_build
from .attention_kernels import MASK_FILL, check_device, two_phase_masks

KERNEL_WINDOW = 16
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SUBLAYER_OPERANDS = ("ln", "wq", "wkv", "wk", "wv", "wo")
FFN_OPERANDS = ("ln", "w1", "b1", "w2", "b2")


# ---------------------------------------------------------------------------
# Operand packing
# ---------------------------------------------------------------------------


def _ln_operand(norm, dtype: torch.dtype) -> torch.Tensor:
    """A LayerNorm's (scale, bias) as (2, D) fp32 holding values of dtype."""
    return torch.stack([norm.scale, norm.bias]).to(dtype).float()


def sublayer_weights(layer, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """The attention sublayer of a ``models/transformer.TransformerLayer`` ->
    (ln (2, D) fp32, wq, wkv, wk, wv, wo in dtype): ``sublayer_weights`` of
    ``ops/pallas_sublayer.py``."""
    att = layer.attention
    return (_ln_operand(layer.attention_norm, dtype), att.q_up.w.to(dtype),
            att.kv_down.w.to(dtype), att.k_up.w.to(dtype), att.v_up.w.to(dtype),
            att.out.w.to(dtype))


def _ffn_weights(layer, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    ff = layer.ff
    return (_ln_operand(layer.ff_norm, dtype), ff.in_proj.w.to(dtype),
            ff.in_proj.b.reshape(1, -1).to(dtype), ff.out_proj.w.to(dtype),
            ff.out_proj.b.reshape(1, -1).to(dtype))


def pair_weights(pair, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """An ``AlternatingLayer`` -> the 22 operands of :func:`transformer_pair`
    in ``pair_weights`` order (``ops/pallas_pair.py``): for the local, then
    the global layer, ln1, wq, wkv, wk, wv, wo, ln2, w1, b1 (1, 2I), w2,
    b2 (1, D)."""
    out = ()
    for side in ("local", "global"):
        layer = pair.get_submodule(side)
        out += sublayer_weights(layer, dtype) + _ffn_weights(layer, dtype)
    return out


def pair_supported(p_len: int, d: int, num_heads: int, window: int) -> bool:
    """The JAX package's geometry gate of kernels 17 and 18
    (``ops/pallas_pair.py`` ``pair_supported``), its fast-memory term
    included, so that both packages route every geometry alike."""
    hd = d // num_heads if num_heads else 0
    return (
        window > 0
        and window % 2 == 0
        and p_len % 16 == 0
        and p_len % window == 0
        and d % 128 == 0
        and num_heads > 0
        and d % num_heads == 0
        and hd % 2 == 0
        and (hd // 2) % 8 == 0
        and p_len * d * 2 * 22 <= 13 * 1024 * 1024
    )


# ---------------------------------------------------------------------------
# Plain pieces (the TPU kernels' bodies, step by step)
# ---------------------------------------------------------------------------


def _query_scale(hd: int, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(1.0 / math.sqrt(hd), dtype=dtype)


def _ln_rows(x: torch.Tensor, ln: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm with the (2, D) operand, cast to x's dtype."""
    return a2m_nn.layer_norm(x, ln[0], ln[1])


def _matmul(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    out = a.float() @ w.float()
    if b is not None:
        out = out + b.float().reshape(-1)
    return out.to(a.dtype)


def _rope_rows(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               num_heads: int) -> torch.Tensor:
    """Halves-layout RoPE per head on (..., rows, H*hd); cos/sin (rows, hd/2)."""
    *lead, rows, width = t.shape
    th = t.reshape(*lead, rows, num_heads, width // num_heads)
    return rope_with(th, cos, sin).reshape(t.shape)


def _mha(q, k, v, mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Per-head masked attention on (..., rows, H*hd) with an fp32 softmax
    whose weights are cast to v's dtype before the product."""
    *lead, rows, width = q.shape
    hd = width // num_heads
    split = lambda t: t.reshape(*lead, rows, num_heads, hd).float()
    qh = split(q * _query_scale(hd, q.dtype).to(q.device))
    logits = torch.einsum("...shd,...Shd->...hsS", qh, split(k))
    logits = torch.where(mask, logits, torch.full_like(logits, MASK_FILL))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("...hsS,...Shd->...shd", weights.float(), split(v))
    return out.reshape(q.shape).to(v.dtype)


def _row_valid(p_len: int, pad_l: int, valid_len: int, device) -> torch.Tensor:
    idx = torch.arange(p_len, device=device)
    return ((idx >= pad_l) & (idx < pad_l + valid_len))[:, None]


def _masked(t: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return torch.where(rows, t, torch.zeros_like(t))


def _two_phase(q, k, v, tables, num_heads: int, window: int) -> torch.Tensor:
    """The two-phase windowed attention with the overlap average in padded
    coordinates; tables: per-padded-row cos_a, sin_a, cos_b, sin_b."""
    cos_a, sin_a, cos_b, sin_b = tables
    mask_a, mask_b, b_rows = two_phase_masks(q.shape[-2], window, q.device)
    rope = lambda t, c, s: _rope_rows(t, c, s, num_heads)
    out_a = _mha(rope(q, cos_a, sin_a), rope(k, cos_a, sin_a), v, mask_a, num_heads)
    out_b = _mha(rope(q, cos_b, sin_b), rope(k, cos_b, sin_b), v, mask_b, num_heads)
    out_b = _masked(out_b, b_rows)
    inv_count = torch.where(b_rows, 0.5, 1.0)
    return ((out_a.float() + out_b.float()) * inv_count).to(q.dtype)


def _attention_sublayer(x, weights, tables, num_heads: int, valid_len: int, pad_l: int,
                        window: int) -> torch.Tensor:
    """x + mask(attention(mask(LN(x))) . wo); window > 0: the local branch
    with its crop-and-shift quirk, window 0: the global one."""
    ln, wq, wkv, wk, wv, wo = weights
    p_len = x.shape[-2]
    rows = _row_valid(p_len, pad_l, valid_len, x.device)
    normed = _masked(_ln_rows(x, ln), rows)
    q, ckv = _matmul(normed, wq), _matmul(normed, wkv)
    k, v = _matmul(ckv, wk), _matmul(ckv, wv)
    if window:
        avg = _two_phase(q, k, v, tables, num_heads, window)
        # The first valid_len rows of the average, re-stored at pad_l.
        r = F.pad(avg[..., :valid_len, :], (0, 0, pad_l, p_len - pad_l - valid_len))
    else:
        cos_g, sin_g = tables
        cols = torch.arange(p_len, device=x.device)
        gmask = ((cols >= pad_l) & (cols < pad_l + valid_len))[None, :].expand(p_len, p_len)
        r = _mha(_rope_rows(q, cos_g, sin_g, num_heads), _rope_rows(k, cos_g, sin_g, num_heads),
                 v, gmask, num_heads)
    return x + _masked(_matmul(r, wo), rows)


def _ffn_sublayer(x, weights, pad_l: int, valid_len: int) -> torch.Tensor:
    """x + mask(GLU FFN(LN(x))): the LayerNorm on every row, the gate split
    at this side's own h1 width."""
    ln, w1, b1, w2, b2 = weights
    h1 = _matmul(_ln_rows(x, ln), w1, b1)
    inter = h1.shape[-1] // 2
    gate = a2m_nn.gelu(h1[..., :inter]) * h1[..., inter:]
    rows = _row_valid(x.shape[-2], pad_l, valid_len, x.device)
    return x + _masked(_matmul(gate, w2, b2), rows)


# ---------------------------------------------------------------------------
# The CUDA side
# ---------------------------------------------------------------------------


def _dtype_code(x: torch.Tensor, what: str) -> int:
    if x.dtype == torch.float16:
        raise NotImplementedError(f"{what} takes f32 and bf16, not f16")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    return _DTYPE_CODES[x.dtype]


def _expect(what: str, name: str, t: torch.Tensor, shape, dtype: torch.dtype,
            like: torch.Tensor) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != like.device
            or not t.is_contiguous()):
        raise ValueError(f"{what}: {name} must be contiguous {dtype} {tuple(shape)} on "
                         f"{like.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_cuda_x(x: torch.Tensor, what: str) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA, not {x.device}")
    code = _dtype_code(x, what)
    if x.dim() != 3 or not x.is_contiguous() or 0 in x.shape:
        raise ValueError(f"{what}: x must be a contiguous non-empty (B, P, D), "
                         f"got {tuple(x.shape)}")
    if x.shape[0] > 65535:
        raise ValueError(f"{what}: at most 65535 samples per call")
    return code


def _check_attention_operands(what: str, x: torch.Tensor, ws, num_heads: int) -> tuple[int, int]:
    """(head dim, compressed kv width) of wq, wkv, wk, wv, wo for x."""
    wq, wkv, wk, wv, wo = ws
    d = x.shape[-1]
    width, ckv = wq.shape[-1], wkv.shape[-1]
    if num_heads < 1 or width % num_heads or width // num_heads not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: width {width} is not {num_heads} heads of {KERNEL_HEAD_DIMS}")
    for name, t, shape in (("wq", wq, (d, width)), ("wkv", wkv, (d, ckv)), ("wk", wk, (ckv, width)),
                           ("wv", wv, (ckv, width)), ("wo", wo, (width, d))):
        _expect(what, name, t, shape, x.dtype, x)
    return width // num_heads, ckv


def _check_tables(what: str, tables, rows: int, hd: int, like: torch.Tensor) -> None:
    for t in tables:
        if t.dim() != 2 or t.shape[0] < rows:
            raise ValueError(f"{what}: a RoPE table must hold at least {rows} rows, "
                             f"got {tuple(t.shape)}")
        _expect(what, "a RoPE table", t, (t.shape[0], hd // 2), torch.float32, like)


def _check_padded(what: str, p_len: int, valid_len: int, pad_l: int, window: int) -> None:
    """The padded geometry of kernels 17 and 18 (window 0: a global sublayer)."""
    if window not in (0, KERNEL_WINDOW) or p_len % KERNEL_WINDOW:
        raise ValueError(f"{what} takes window {KERNEL_WINDOW} and P % {KERNEL_WINDOW} == 0, "
                         f"got window {window}, P {p_len}")
    if valid_len < 1 or pad_l < 0 or pad_l + valid_len > p_len:
        raise ValueError(f"{what}: rows [{pad_l}, {pad_l + valid_len}) do not lie in P={p_len}")


def _workspace(need: int, what: str, x: torch.Tensor) -> torch.Tensor:
    if need <= 0:
        raise ValueError(f"{what} does not take x of shape {tuple(x.shape)}")
    return torch.empty(need, dtype=torch.uint8, device=x.device)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream



# ---------------------------------------------------------------------------
# Kernel 11: the attention block
# ---------------------------------------------------------------------------


def attention_block_plain(x, wq, wkv, wk, wv, wo, cos, sin, num_heads: int, valid_len: int,
                          window: int = 0) -> torch.Tensor:
    """Plain version of :func:`attention_block`, as the JAX package's
    ``_attention_layer_reference`` (the windowed rows, the count average of
    the overlapping halves) with the kernel's roundings: q scaled in its
    dtype, fp32 logits, the weights cast before the product with v."""
    b, p_len, d = x.shape
    if window:
        stride = window // 2
        nb = p_len // stride
        blocks = x.reshape(b, nb, stride, d)
        xa = torch.cat([blocks[:, :-1], blocks[:, 1:]], dim=2).reshape(b, (nb - 1) * window, d)
        n = kv_valid = xa.shape[1]
    else:
        xa, n, kv_valid = x, p_len, valid_len
    q, ckv = _matmul(xa, wq), _matmul(xa, wkv)
    k, v = _matmul(ckv, wk), _matmul(ckv, wv)
    q = _rope_rows(q, cos[:n], sin[:n], num_heads)
    k = _rope_rows(k, cos[:n], sin[:n], num_heads)
    idx = torch.arange(n, device=x.device)
    mask = (idx < kv_valid)[None, :].expand(n, n)
    if window:
        mask = mask & (idx[:, None] // window == idx[None, :] // window)
    attn = _mha(q, k, v, mask, num_heads)
    if window:
        width = attn.shape[-1]
        ow = attn.reshape(b, nb - 1, window, width)
        zeros = attn.new_zeros(b, 1, stride, width)
        block_sum = (torch.cat([ow[:, :, :stride], zeros], dim=1)
                     + torch.cat([zeros, ow[:, :, stride:]], dim=1))
        count = torch.ones(nb, device=x.device)
        count[1:-1] = 2.0
        attn = (block_sum.float() / count[None, :, None, None]).to(attn.dtype)
        attn = attn.reshape(b, p_len, width)
    return _matmul(attn, wo)


def attention_block(x, wq, wkv, wk, wv, wo, cos, sin, num_heads: int, valid_len: int,
                    window: int = 0) -> torch.Tensor:
    """The attention block of a layer on x (B, P, D), pre-normed: q / kv /
    k / v products, RoPE, attention, out-proj (no bias).

    ``window`` 16: P padded rows (a multiple of 8) windowed at stride 8, the
    overlapping halves averaged, every row returned (the caller crops); cos,
    sin (n, hd/2) with n >= (P/8 - 1) * 16, the table of the windowed rows
    (positions restarting every 16).  ``window`` 0: global attention over
    the columns < ``valid_len``; cos, sin with at least P rows of absolute
    positions.  Runs as :func:`attention_block_fwd`."""
    check_device(x, "attention_block")
    return attention_block_fwd(x, wq, wkv, wk, wv, wo, cos, sin, num_heads, valid_len, window)


def _attention_block_checks(x, wq, wkv, wk, wv, wo, cos, sin, num_heads: int, valid_len: int,
                            window: int) -> tuple[int, int, int]:
    """-> (dtype code, hd, ckv) of a CUDA launch of kernel 11; raises on what
    it does not take.  Shapes only: it runs on fake tensors too."""
    what = "attention_block"
    code = _check_cuda_x(x, what)
    p_len = x.shape[1]
    hd, ckv = _check_attention_operands(what, x, (wq, wkv, wk, wv, wo), num_heads)
    if window:
        if window != KERNEL_WINDOW or p_len % (window // 2) or p_len < window:
            raise ValueError(f"{what} takes window {KERNEL_WINDOW} over P a multiple of 8 and "
                             f"at least 16, got window {window}, P {p_len}")
        rows = (p_len // (window // 2) - 1) * window
    else:
        if not 0 < valid_len <= p_len:
            raise ValueError(f"{what}: valid_len {valid_len} out of range for P={p_len}")
        rows = p_len
    _check_tables(what, (cos, sin), rows, hd, x)
    return code, hd, ckv


@torch.library.custom_op(
    "a2m::attention_block_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor wq, Tensor wkv, Tensor wk, Tensor wv, Tensor wo, Tensor cos, "
           "Tensor sin, int num_heads, int valid_len, int window) -> Tensor")
def attention_block_fwd(x, wq, wkv, wk, wv, wo, cos, sin, num_heads, valid_len, window):
    """Kernel 11 as one operator, ``torch.ops.a2m.attention_block_fwd``: the
    plain version on the CPU, the kernel on the card (counted in
    ``attention_block.launches``), and a fake implementation that gives the
    output's shape, dtype and strides and runs the geometry checks."""
    return attention_block_plain(x, wq, wkv, wk, wv, wo, cos, sin, num_heads, valid_len,
                                 window)


@attention_block_fwd.register_kernel("cuda")
def _attention_block_fwd_cuda(x, wq, wkv, wk, wv, wo, cos, sin, num_heads, valid_len, window):
    code, hd, ckv = _attention_block_checks(x, wq, wkv, wk, wv, wo, cos, sin, num_heads,
                                            valid_len, window)
    what = "attention_block"
    b, p_len, d = x.shape
    lib = cuda_build.library()
    workspace = _workspace(lib.a2m_attention_block_workspace(b, p_len, d, num_heads, hd, ckv, code),
                           what, x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.a2m_attention_block(
            x.data_ptr(), wq.data_ptr(), wkv.data_ptr(), wk.data_ptr(), wv.data_ptr(),
            wo.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), workspace.data_ptr(),
            b, p_len, d, num_heads, hd, ckv, valid_len, window, cos.shape[0],
            float(_query_scale(hd, x.dtype)), code, _stream(x))
    cuda_build.check(err, what)
    attention_block.launches += 1
    return out


@attention_block_fwd.register_fake
def _attention_block_fwd_fake(x, wq, wkv, wk, wv, wo, cos, sin, num_heads, valid_len, window):
    if x.device.type == "cuda":
        _attention_block_checks(x, wq, wkv, wk, wv, wo, cos, sin, num_heads, valid_len, window)
    return x.new_empty(x.shape)


# ---------------------------------------------------------------------------
# Kernel 18: the fused attention sublayers
# ---------------------------------------------------------------------------


def fused_sublayer_plain(xp, weights, tables, *, num_heads: int, valid_len: int, pad_l: int,
                         window: int = 0) -> torch.Tensor:
    """Plain version of :func:`fused_local_sublayer` (``window`` > 0, tables
    cos_a, sin_a, cos_b, sin_b) and :func:`fused_global_sublayer` (0, tables
    cos_g, sin_g)."""
    return _attention_sublayer(xp, weights, tables, num_heads, valid_len, pad_l, window)


def _sublayer_checks(what: str, xp, weights, tables, num_heads: int, valid_len: int,
                     pad_l: int, window: int) -> tuple[int, int, int]:
    """-> (dtype code, hd, ckv) of a CUDA launch of kernel 18; shapes only."""
    code = _check_cuda_x(xp, what)
    d, p_len = xp.shape[2], xp.shape[1]
    if len(weights) != len(SUBLAYER_OPERANDS):
        raise ValueError(f"{what} takes the {len(SUBLAYER_OPERANDS)} operands of sublayer_weights")
    _check_padded(what, p_len, valid_len, pad_l, window)
    _expect(what, "ln", weights[0], (2, d), torch.float32, xp)
    hd, ckv = _check_attention_operands(what, xp, weights[1:], num_heads)
    _check_tables(what, tables, p_len, hd, xp)
    return code, hd, ckv


@torch.library.custom_op(
    "a2m::fused_sublayer_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor xp, Tensor[] weights, Tensor[] tables, int num_heads, int valid_len, "
           "int pad_l, int window) -> Tensor")
def fused_sublayer_fwd(xp, weights, tables, num_heads, valid_len, pad_l, window):
    """Kernel 18 as one operator, ``torch.ops.a2m.fused_sublayer_fwd``: the
    local sublayer for ``window`` > 0 (4 tables), the global one for 0 (2
    tables).  The plain version on the CPU, the kernel on the card (counted
    in ``fused_local_sublayer.launches`` or ``fused_global_sublayer``'s),
    and a fake implementation that gives the output's shape, dtype and
    strides and runs the geometry checks."""
    return fused_sublayer_plain(xp, weights, tables, num_heads=num_heads, valid_len=valid_len,
                                pad_l=pad_l, window=window)


@fused_sublayer_fwd.register_kernel("cuda")
def _fused_sublayer_fwd_cuda(xp, weights, tables, num_heads, valid_len, pad_l, window):
    wrapper = fused_local_sublayer if window else fused_global_sublayer
    what = wrapper.__name__
    code, hd, ckv = _sublayer_checks(what, xp, weights, tables, num_heads, valid_len, pad_l,
                                     window)
    b, p_len, d = xp.shape
    lib = cuda_build.library()
    workspace = _workspace(lib.a2m_fused_sublayer_workspace(b, p_len, d, num_heads, hd, ckv, code),
                           what, xp)
    out = torch.empty_like(xp)
    entry = lib.a2m_fused_local_sublayer if window else lib.a2m_fused_global_sublayer
    with torch.cuda.device(xp.device):
        err = entry(
            xp.data_ptr(), *(w.data_ptr() for w in weights), *(t.data_ptr() for t in tables),
            out.data_ptr(), workspace.data_ptr(), b, p_len, d, num_heads, hd, ckv, valid_len,
            pad_l, float(_query_scale(hd, xp.dtype)), code, _stream(xp))
    cuda_build.check(err, what)
    wrapper.launches += 1
    return out


@fused_sublayer_fwd.register_fake
def _fused_sublayer_fwd_fake(xp, weights, tables, num_heads, valid_len, pad_l, window):
    if xp.device.type == "cuda":
        what = "fused_local_sublayer" if window else "fused_global_sublayer"
        _sublayer_checks(what, xp, weights, tables, num_heads, valid_len, pad_l, window)
    return xp.new_empty(xp.shape)


def fused_local_sublayer(xp, weights, tables, *, num_heads: int, valid_len: int, pad_l: int,
                         window: int) -> torch.Tensor:
    """xp (B, P, D) in padded coordinates (P a multiple of 16) -> xp + the
    local attention sublayer of it.  weights: :func:`sublayer_weights`;
    tables: cos_a, sin_a, cos_b, sin_b (P, hd/2), the per-row tables of the
    two phases.  Runs as :func:`fused_sublayer_fwd`."""
    if len(tables) != 4:
        raise ValueError("fused_local_sublayer takes the four phase tables")
    if window <= 0:
        raise ValueError(f"fused_local_sublayer takes window {KERNEL_WINDOW}, got {window}")
    check_device(xp, "fused_local_sublayer")
    return fused_sublayer_fwd(xp, list(weights), list(tables), num_heads, valid_len, pad_l,
                              window)


def fused_global_sublayer(xp, weights, tables, *, num_heads: int, valid_len: int,
                          pad_l: int) -> torch.Tensor:
    """As :func:`fused_local_sublayer` for the global sublayer; tables:
    cos_g, sin_g (P, hd/2), positions counted from row pad_l."""
    if len(tables) != 2:
        raise ValueError("fused_global_sublayer takes the two global tables")
    check_device(xp, "fused_global_sublayer")
    return fused_sublayer_fwd(xp, list(weights), list(tables), num_heads, valid_len, pad_l, 0)


# ---------------------------------------------------------------------------
# Kernel 17: the transformer pair
# ---------------------------------------------------------------------------


def transformer_pair_plain(xp, weights, tables, *, num_heads: int, valid_len: int, pad_l: int,
                           window: int) -> torch.Tensor:
    """Plain version of :func:`transformer_pair`: ``_pair_kernel``'s four
    sublayers in turn."""
    local, global_ = weights[:11], weights[11:]
    x = _attention_sublayer(xp, local[:6], tables[:4], num_heads, valid_len, pad_l, window)
    x = _ffn_sublayer(x, local[6:], pad_l, valid_len)
    x = _attention_sublayer(x, global_[:6], tables[4:], num_heads, valid_len, pad_l, 0)
    return _ffn_sublayer(x, global_[6:], pad_l, valid_len)


def transformer_pair(xp, weights, tables, *, num_heads: int, valid_len: int, pad_l: int,
                     window: int) -> torch.Tensor:
    """A whole alternating pair on xp (B, P, D) in padded coordinates (P a
    multiple of 16).  weights: the 22 of :func:`pair_weights`; tables:
    cos_a, sin_a, cos_b, sin_b, cos_g, sin_g (P, hd/2).  Runs as
    :func:`transformer_pair_fwd`."""
    check_device(xp, "transformer_pair")
    return transformer_pair_fwd(xp, list(weights), list(tables), num_heads, valid_len, pad_l,
                                window)


def _pair_checks(xp, weights, tables, num_heads: int, valid_len: int, pad_l: int,
                 window: int) -> tuple[int, int, int, int]:
    """-> (dtype code, hd, ckv, inter) of a CUDA launch of kernel 17; shapes
    only."""
    what = "transformer_pair"
    code = _check_cuda_x(xp, what)
    d, p_len = xp.shape[2], xp.shape[1]
    if len(weights) != 2 * (len(SUBLAYER_OPERANDS) + len(FFN_OPERANDS)) or len(tables) != 6:
        raise ValueError(f"{what} takes the 22 operands of pair_weights and 6 tables")
    if window != KERNEL_WINDOW:
        raise ValueError(f"{what} takes window {KERNEL_WINDOW}, got {window}")
    _check_padded(what, p_len, valid_len, pad_l, window)
    hd = ckv = inter = 0
    for side in (weights[:11], weights[11:]):
        _expect(what, "ln", side[0], (2, d), torch.float32, xp)
        hd, ckv = _check_attention_operands(what, xp, side[1:6], num_heads)
        ln2, w1, b1, w2, b2 = side[6:]
        inter = w1.shape[-1] // 2
        for name, t, shape in (("w1", w1, (d, 2 * inter)), ("b1", b1, (1, 2 * inter)),
                               ("w2", w2, (inter, d)), ("b2", b2, (1, d))):
            _expect(what, name, t, shape, xp.dtype, xp)
        _expect(what, "ln", ln2, (2, d), torch.float32, xp)
    if (weights[7].shape, weights[1].shape, weights[2].shape) != (
            weights[18].shape, weights[12].shape, weights[13].shape) or inter < 1:
        raise ValueError(f"{what}: the local and global sides must share their widths")
    _check_tables(what, tables, p_len, hd, xp)
    return code, hd, ckv, inter


@torch.library.custom_op(
    "a2m::transformer_pair_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor xp, Tensor[] weights, Tensor[] tables, int num_heads, int valid_len, "
           "int pad_l, int window) -> Tensor")
def transformer_pair_fwd(xp, weights, tables, num_heads, valid_len, pad_l, window):
    """Kernel 17 as one operator, ``torch.ops.a2m.transformer_pair_fwd``:
    the plain version on the CPU, the kernel on the card (counted in
    ``transformer_pair.launches``), and a fake implementation that gives the
    output's shape, dtype and strides and runs the geometry checks."""
    return transformer_pair_plain(xp, weights, tables, num_heads=num_heads,
                                  valid_len=valid_len, pad_l=pad_l, window=window)


@transformer_pair_fwd.register_kernel("cuda")
def _transformer_pair_fwd_cuda(xp, weights, tables, num_heads, valid_len, pad_l, window):
    what = "transformer_pair"
    code, hd, ckv, inter = _pair_checks(xp, weights, tables, num_heads, valid_len, pad_l, window)
    b, p_len, d = xp.shape
    lib = cuda_build.library()
    workspace = _workspace(
        lib.a2m_transformer_pair_workspace(b, p_len, d, num_heads, hd, ckv, inter, code), what, xp)
    out = torch.empty_like(xp)
    w_ptrs = (ctypes.c_void_p * len(weights))(*(w.data_ptr() for w in weights))
    t_ptrs = (ctypes.c_void_p * len(tables))(*(t.data_ptr() for t in tables))
    with torch.cuda.device(xp.device):
        err = lib.a2m_transformer_pair(
            xp.data_ptr(), ctypes.cast(w_ptrs, ctypes.c_void_p), ctypes.cast(t_ptrs, ctypes.c_void_p),
            out.data_ptr(), workspace.data_ptr(), b, p_len, d, num_heads, hd, ckv, inter,
            valid_len, pad_l, float(_query_scale(hd, xp.dtype)), code, _stream(xp))
    cuda_build.check(err, what)
    transformer_pair.launches += 1
    return out


@transformer_pair_fwd.register_fake
def _transformer_pair_fwd_fake(xp, weights, tables, num_heads, valid_len, pad_l, window):
    if xp.device.type == "cuda":
        _pair_checks(xp, weights, tables, num_heads, valid_len, pad_l, window)
    return xp.new_empty(xp.shape)


for _fn in (attention_block, fused_local_sublayer, fused_global_sublayer, transformer_pair):
    _fn.launches = 0

# Every kernel wrapper of this module, for resetting and reading the counts.
KERNELS = (attention_block, fused_local_sublayer, fused_global_sublayer, transformer_pair)
