"""The attention kernels of the serving and training paths, with their plain
versions.

Counterpart of kernels 1, 2, 7 and 9 of
``audio_to_midi_tpu/ops/pallas_attention.py``:

* :func:`global_attention` -- ``fused_attention_nhd`` (global layers, and
  the block-diagonal flattened-window fallback of the local layers).
  CUDA source: ``csrc/global_attention.cu``.
* :func:`local_two_phase` -- ``fused_local_two_phase`` (local layers).
  CUDA source: ``csrc/local_attention.cu``.
* :func:`global_attention_grads` -- ``nhd_grads``: dq, dk, dv of the global
  attention, optionally with the uint8 dropout bits its forward applied.
  CUDA source: ``csrc/global_attention_bwd.cu``.
* :func:`local_two_phase_grads` -- ``two_phase_grads``: dqa, dka, dqb, dkb,
  dv of the two-phase local attention.
  CUDA source: ``csrc/local_attention_bwd.cu``.

Each wrapper takes the kernel's plain PyTorch version only for tensors on
the CPU.  On a CUDA tensor it launches the kernel or raises: f16 raises
``NotImplementedError`` (the JAX package sends f16 to XLA too, it is a
training loss-scaling policy), and a geometry the kernel does not take
raises ``ValueError``.  Each wrapper counts its launches in ``.launches``.
The source notes in ``csrc/`` say what bounds each kernel on the card and
how its design deals with that.

Both forwards are ``torch.autograd.Function``s on either device: they save
their inputs, as the JAX ``custom_vjp``s do, and their backward goes through
the ``*_grads`` wrappers -- the plain backward on the CPU, the CUDA backward
kernel on the card, never autograd through the plain forward.
"""

from __future__ import annotations

import math

import torch

from . import cuda_build

MASK_FILL = -1e30           # the TPU kernels' masked-logit value
KERNEL_HEAD_DIMS = (16, 32, 64)
KERNEL_WINDOW = 16
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _query_scale(hd: int, dtype: torch.dtype) -> torch.Tensor:
    """1/sqrt(hd) in the input dtype: the TPU kernels scale q in its dtype."""
    return torch.tensor(1.0 / math.sqrt(hd), dtype=dtype)


def _check_cuda(tensors: tuple[torch.Tensor, ...], num_heads: int) -> tuple[torch.dtype, int]:
    """(dtype, head dim) of inputs the kernels take; raises on the rest."""
    first = tensors[0]
    dtype = first.dtype
    hd = first.shape[-1] // num_heads
    if dtype == torch.float16:
        raise NotImplementedError("the attention kernels take f32 and bf16, not f16")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {dtype}")
    for t in tensors:
        if t.device != first.device or t.dtype != dtype or t.shape != first.shape:
            raise ValueError("attention inputs must share device, dtype and shape")
        if not t.is_contiguous():
            raise ValueError("attention inputs must be contiguous")
    if first.shape[-1] != num_heads * hd or hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"width {first.shape[-1]} is not {num_heads} heads of {KERNEL_HEAD_DIMS}")
    if first.shape[0] > 65535:
        raise ValueError("at most 65535 samples per call")
    return dtype, hd


def _stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(G, S, H*hd) -> head-major (G, H, S, hd)."""
    g, s, dm = x.shape
    return x.reshape(g, s, num_heads, dm // num_heads).transpose(1, 2)


def _unheads(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(G, H, S, hd) -> (G, S, H*hd) in ``dtype``."""
    g, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(g, s, h * hd).to(dtype)


def _apply_bits(x: torch.Tensor, bits: torch.Tensor, threshold: int) -> torch.Tensor:
    """Inverted dropout from uint8 bits: keep where ``bits >= threshold``,
    kept values scaled by 256 / (256 - threshold).  x: fp32."""
    if not 0 < threshold < 256:
        raise ValueError(f"dropout threshold {threshold} out of (0, 256)")
    keep = bits.to(torch.int32) >= threshold
    return torch.where(keep, x * (256.0 / (256.0 - threshold)), torch.zeros_like(x))


def _core_grads(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    mask: torch.Tensor, scale: torch.Tensor,
    bits: torch.Tensor | None = None, threshold: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Input gradients of one attention core, step by step as the TPU
    backward kernels compute them (``_core_grads`` of the JAX package).

    q, k, v: (..., S, hd) in the working dtype; do: (..., S, hd) fp32;
    mask: (S, S) bool; scale: 0-d tensor in the working dtype.  Returns
    (dq, dk, dv) in fp32.  Every product accumulates in fp32; the operands
    are rounded to the working dtype where the TPU kernel rounds them.
    """
    qs = (q * scale).float()                       # q scaled in its own dtype
    logits = qs @ k.float().transpose(-1, -2)
    logits = torch.where(mask, logits, torch.full_like(logits, MASK_FILL))
    w = torch.softmax(logits, dim=-1)
    w_used = w if bits is None else _apply_bits(w, bits, threshold)
    w_cast = w_used.to(v.dtype).float()            # the forward cast w before w.v
    do_cast = do.to(v.dtype).float()
    dv = w_cast.transpose(-1, -2) @ do_cast
    dw = do_cast @ v.float().transpose(-1, -2)
    if bits is not None:
        dw = _apply_bits(dw, bits, threshold)
    dlogits = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
    dlogits = torch.where(mask, dlogits, torch.zeros_like(dlogits)).to(q.dtype).float()
    dq = (dlogits @ k.float()) * scale.float()
    dk = dlogits.transpose(-1, -2) @ qs
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Kernel 1: global attention over (G, S, H*hd)
# ---------------------------------------------------------------------------


def _global_mask(s: int, block: int, valid_len: int, device) -> torch.Tensor:
    idx = torch.arange(s, device=device)
    mask = (idx < valid_len)[None, :].expand(s, s)
    if block > 0:
        mask = mask & (idx[:, None] // block == idx[None, :] // block)
    return mask


def global_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    block: int = 0, valid_len: int | None = None,
) -> torch.Tensor:
    """Plain version of :func:`global_attention`."""
    g, s, dm = q.shape
    hd = dm // num_heads
    valid_len = s if valid_len is None else valid_len
    qs = (q * _query_scale(hd, q.dtype).to(q.device)).float().reshape(g, s, num_heads, hd)
    kf = k.float().reshape(g, s, num_heads, hd)
    vf = v.float().reshape(g, s, num_heads, hd)
    logits = torch.einsum("gshd,gShd->ghsS", qs, kf)
    mask = _global_mask(s, block, valid_len, q.device)
    logits = torch.where(mask, logits, torch.full_like(logits, MASK_FILL))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("ghsS,gShd->gshd", weights, vf)
    return out.reshape(g, s, dm).to(q.dtype)


def global_attention_grads_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, num_heads: int,
    block: int = 0, valid_len: int | None = None,
    bits: torch.Tensor | None = None, threshold: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`global_attention_grads`."""
    s = q.shape[1]
    valid_len = s if valid_len is None else valid_len
    scale = _query_scale(q.shape[-1] // num_heads, q.dtype).to(q.device)
    mask = _global_mask(s, block, valid_len, q.device)
    dq, dk, dv = _core_grads(
        _heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads),
        _heads(g, num_heads).float(), mask, scale, bits, threshold)
    return _unheads(dq, q.dtype), _unheads(dk, q.dtype), _unheads(dv, q.dtype)


def _check_global(s: int, block: int, valid_len: int | None) -> int:
    valid_len = s if valid_len is None else valid_len
    if not 0 < valid_len <= s or block < 0:
        raise ValueError(f"valid_len {valid_len} / block {block} out of range for S={s}")
    return valid_len


def _global_attention_forward(q, k, v, num_heads: int, block: int, valid_len: int | None):
    if q.device.type == "cpu":
        return global_attention_plain(q, k, v, num_heads, block, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"global_attention runs on CPU or CUDA, not {q.device}")
    g, s, _ = q.shape
    dtype, hd = _check_cuda((q, k, v), num_heads)
    valid_len = _check_global(s, block, valid_len)
    out = torch.empty_like(q)
    scale = float(_query_scale(hd, dtype))
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        code = lib.a2m_global_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g, s, num_heads, hd, valid_len, block, scale, _DTYPE_CODES[dtype],
            _stream_handle(q.device),
        )
    cuda_build.check(code, "global_attention")
    global_attention.launches += 1
    return out


def global_attention_grads(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, num_heads: int,
    block: int = 0, valid_len: int | None = None,
    bits: torch.Tensor | None = None, threshold: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`global_attention` for the output cotangent ``g``.

    The softmax is recomputed from q and k; the operands of the five
    products are rounded where the TPU kernel rounds them (see
    :func:`_core_grads`).  ``bits`` (G, H, S, S) uint8 with ``threshold`` in
    (0, 256) are the dropout bits of a forward that applied them: a weight
    is kept where ``bits >= threshold`` and scaled by 256/(256 - threshold).
    """
    if q.device.type == "cpu":
        return global_attention_grads_plain(q, k, v, g, num_heads, block, valid_len,
                                            bits, threshold)
    if q.device.type != "cuda":
        raise ValueError(f"global_attention_grads runs on CPU or CUDA, not {q.device}")
    n, s, _ = q.shape
    dtype, hd = _check_cuda((q, k, v, g), num_heads)
    valid_len = _check_global(s, block, valid_len)
    if bits is None:
        threshold = 0
    else:
        if not 0 < threshold < 256:
            raise ValueError(f"dropout threshold {threshold} out of (0, 256)")
        if (bits.dtype != torch.uint8 or bits.device != q.device or not bits.is_contiguous()
                or tuple(bits.shape) != (n, num_heads, s, s)):
            raise ValueError("bits must be contiguous uint8 (G, H, S, S) on q's device")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    # Per-row softmax max, 1/sum and sum_c dw.w, written by the dq pass and
    # read by the dk/dv pass.
    stats = torch.empty((n, num_heads, 3, s), dtype=torch.float32, device=q.device)
    scale = float(_query_scale(hd, dtype))
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        code = lib.a2m_global_attention_grads(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            None if bits is None else bits.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            n, s, num_heads, hd, valid_len, block, threshold, scale, _DTYPE_CODES[dtype],
            _stream_handle(q.device),
        )
    cuda_build.check(code, "global_attention_grads")
    global_attention_grads.launches += 1
    return dq, dk, dv


class _GlobalAttentionFn(torch.autograd.Function):
    """Saves q, k, v; the backward is :func:`global_attention_grads`."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, block, valid_len):
        ctx.save_for_backward(q, k, v)
        ctx.geometry = (num_heads, block, valid_len)
        return _global_attention_forward(q, k, v, num_heads, block, valid_len)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        # The cotangent comes through crops and reshapes and need not be dense.
        dq, dk, dv = global_attention_grads(q, k, v, g.contiguous(), *ctx.geometry)
        return dq, dk, dv, None, None, None


def global_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    block: int = 0, valid_len: int | None = None,
) -> torch.Tensor:
    """Multi-head attention over the natural (G, S, H*hd) layout.

    Per head: softmax((q / sqrt(hd)) k^T) v with q scaled in its dtype, fp32
    softmax and accumulation.  Columns >= ``valid_len`` (default S) are
    masked, and with ``block`` > 0 so is every column outside the row's
    block of ``block`` rows.  Masked logits are -1e30, as in the TPU kernel.
    Returns (G, S, H*hd) in q's dtype.  Differentiable in q, k and v.
    """
    return _GlobalAttentionFn.apply(q, k, v, num_heads, block, valid_len)


global_attention.launches = 0
global_attention_grads.launches = 0


# ---------------------------------------------------------------------------
# Kernel 2: two-phase local attention over (B, P, H*hd)
# ---------------------------------------------------------------------------


def local_two_phase_plain(
    qa: torch.Tensor, ka: torch.Tensor, qb: torch.Tensor, kb: torch.Tensor,
    v: torch.Tensor, num_heads: int, window: int,
) -> torch.Tensor:
    """Plain version of :func:`local_two_phase`: per-phase P x P masked
    attention, as the JAX package's ``_two_phase_reference``."""
    b, p_len, dm = qa.shape
    hd = dm // num_heads
    stride = window // 2
    scale = _query_scale(hd, qa.dtype).to(qa.device)

    idx = torch.arange(p_len, device=qa.device)
    rows, cols = idx[:, None], idx[None, :]
    mask_a = torch.div(rows, window, rounding_mode="floor") == torch.div(
        cols, window, rounding_mode="floor")
    in_band = (cols >= stride) & (cols < p_len - stride)
    mask_b = (torch.div(rows - stride, window, rounding_mode="floor")
              == torch.div(cols - stride, window, rounding_mode="floor")) & in_band
    vh = v.float().reshape(b, p_len, num_heads, hd)

    def mha(q, k, mask):
        qh = (q * scale).float().reshape(b, p_len, num_heads, hd)
        kh = k.float().reshape(b, p_len, num_heads, hd)
        logits = torch.einsum("bshd,bShd->bhsS", qh, kh)
        logits = torch.where(mask, logits, torch.full_like(logits, MASK_FILL))
        weights = torch.softmax(logits, dim=-1)
        return torch.einsum("bhsS,bShd->bshd", weights, vh).reshape(b, p_len, dm)

    out_a = mha(qa, ka, mask_a)
    out_b = mha(qb, kb, mask_b)
    b_rows = ((idx >= stride) & (idx < p_len - stride))[:, None]
    out_b = torch.where(b_rows, out_b, torch.zeros_like(out_b))
    inv = torch.where(b_rows, 0.5, 1.0)
    return ((out_a + out_b) * inv).to(qa.dtype)


def local_two_phase_grads_plain(
    qa: torch.Tensor, ka: torch.Tensor, qb: torch.Tensor, kb: torch.Tensor,
    v: torch.Tensor, g: torch.Tensor, num_heads: int, window: int,
) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`local_two_phase_grads`: per-phase P x P masked
    cores, as the JAX package's ``_two_phase_bwd_core``."""
    p_len = qa.shape[1]
    stride = window // 2
    scale = _query_scale(qa.shape[-1] // num_heads, qa.dtype).to(qa.device)

    idx = torch.arange(p_len, device=qa.device)
    rows, cols = idx[:, None], idx[None, :]
    mask_a = torch.div(rows, window, rounding_mode="floor") == torch.div(
        cols, window, rounding_mode="floor")
    in_band = (cols >= stride) & (cols < p_len - stride)
    mask_b = (torch.div(rows - stride, window, rounding_mode="floor")
              == torch.div(cols - stride, window, rounding_mode="floor")) & in_band
    b_rows = ((idx >= stride) & (idx < p_len - stride))[:, None]

    # The overlap average first, in fp32; phase B sees no edge rows.
    g_a = g.float() * torch.where(b_rows, 0.5, 1.0)
    g_b = torch.where(b_rows, g_a, torch.zeros_like(g_a))
    vh = _heads(v, num_heads)
    dqa, dka, dva = _core_grads(_heads(qa, num_heads), _heads(ka, num_heads), vh,
                                _heads(g_a, num_heads), mask_a, scale)
    dqb, dkb, dvb = _core_grads(_heads(qb, num_heads), _heads(kb, num_heads), vh,
                                _heads(g_b, num_heads), mask_b, scale)
    return tuple(_unheads(t, qa.dtype) for t in (dqa, dka, dqb, dkb, dva + dvb))


def _check_local(p_len: int, window: int) -> None:
    if window != KERNEL_WINDOW or p_len % window:
        raise ValueError(f"the kernel takes window {KERNEL_WINDOW} and P % window == 0, "
                         f"got window {window}, P {p_len}")


def _local_two_phase_forward(qa, ka, qb, kb, v, num_heads: int, window: int):
    if qa.device.type == "cpu":
        return local_two_phase_plain(qa, ka, qb, kb, v, num_heads, window)
    if qa.device.type != "cuda":
        raise ValueError(f"local_two_phase runs on CPU or CUDA, not {qa.device}")
    b, p_len, _ = qa.shape
    dtype, hd = _check_cuda((qa, ka, qb, kb, v), num_heads)
    _check_local(p_len, window)
    out = torch.empty_like(qa)
    scale = float(_query_scale(hd, dtype))
    lib = cuda_build.library()
    with torch.cuda.device(qa.device):
        code = lib.a2m_local_two_phase(
            qa.data_ptr(), ka.data_ptr(), qb.data_ptr(), kb.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, p_len, num_heads, hd, scale, _DTYPE_CODES[dtype],
            _stream_handle(qa.device),
        )
    cuda_build.check(code, "local_two_phase")
    local_two_phase.launches += 1
    return out


def local_two_phase_grads(
    qa: torch.Tensor, ka: torch.Tensor, qb: torch.Tensor, kb: torch.Tensor,
    v: torch.Tensor, g: torch.Tensor, num_heads: int, window: int,
) -> tuple[torch.Tensor, ...]:
    """(dqa, dka, dqb, dkb, dv) of :func:`local_two_phase` for the cotangent
    ``g`` of its overlap-averaged output; dv sums both phases in fp32."""
    if qa.device.type == "cpu":
        return local_two_phase_grads_plain(qa, ka, qb, kb, v, g, num_heads, window)
    if qa.device.type != "cuda":
        raise ValueError(f"local_two_phase_grads runs on CPU or CUDA, not {qa.device}")
    b, p_len, _ = qa.shape
    dtype, hd = _check_cuda((qa, ka, qb, kb, v, g), num_heads)
    _check_local(p_len, window)
    outs = tuple(torch.empty_like(qa) for _ in range(5))
    scale = float(_query_scale(hd, dtype))
    lib = cuda_build.library()
    with torch.cuda.device(qa.device):
        code = lib.a2m_local_two_phase_grads(
            qa.data_ptr(), ka.data_ptr(), qb.data_ptr(), kb.data_ptr(), v.data_ptr(),
            g.data_ptr(), *(t.data_ptr() for t in outs),
            b, p_len, num_heads, hd, scale, _DTYPE_CODES[dtype], _stream_handle(qa.device),
        )
    cuda_build.check(code, "local_two_phase_grads")
    local_two_phase_grads.launches += 1
    return outs


class _LocalTwoPhaseFn(torch.autograd.Function):
    """Saves qa, ka, qb, kb, v; the backward is :func:`local_two_phase_grads`."""

    @staticmethod
    def forward(ctx, qa, ka, qb, kb, v, num_heads, window):
        ctx.save_for_backward(qa, ka, qb, kb, v)
        ctx.geometry = (num_heads, window)
        return _local_two_phase_forward(qa, ka, qb, kb, v, num_heads, window)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        grads = local_two_phase_grads(*ctx.saved_tensors, g.contiguous(), *ctx.geometry)
        return (*grads, None, None)


def local_two_phase(
    qa: torch.Tensor, ka: torch.Tensor, qb: torch.Tensor, kb: torch.Tensor,
    v: torch.Tensor, num_heads: int, window: int,
) -> torch.Tensor:
    """Sliding-window attention (window ``window``, stride window/2) with the
    overlap average, as two non-overlapping phases.

    qa/ka: phase-A roped q/k (windows start at 0, w, 2w, ...); qb/kb:
    phase-B roped q/k (windows start at w/2, 3w/2, ...); v shared.  All
    (B, P, H*hd) with P a multiple of ``window``.  Returns the averaged
    window-attention output in padded coordinates, (B, P, H*hd).
    Differentiable in all five inputs.
    """
    return _LocalTwoPhaseFn.apply(qa, ka, qb, kb, v, num_heads, window)


local_two_phase.launches = 0
local_two_phase_grads.launches = 0

# Every kernel wrapper, for resetting and reading the launch counts.
KERNELS = (global_attention, local_two_phase, global_attention_grads, local_two_phase_grads)
