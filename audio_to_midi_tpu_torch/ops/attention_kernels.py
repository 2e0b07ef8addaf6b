"""The two attention kernels of the serving path, with their plain versions.

Counterpart of kernels 1-2 of ``audio_to_midi_tpu/ops/pallas_attention.py``:

* :func:`global_attention` -- ``fused_attention_nhd`` (global layers, and
  the block-diagonal flattened-window fallback of the local layers).
  CUDA source: ``csrc/global_attention.cu``.
* :func:`local_two_phase` -- ``fused_local_two_phase`` (local layers).
  CUDA source: ``csrc/local_attention.cu``.

Each wrapper takes the kernel's plain PyTorch version only for tensors on
the CPU.  On a CUDA tensor it launches the kernel or raises: f16 raises
``NotImplementedError`` (the JAX package sends f16 to XLA too, it is a
training loss-scaling policy), and a geometry the kernel does not take
raises ``ValueError``.  Each wrapper counts its launches in ``.launches``.
The source notes in ``csrc/`` say what bounds each kernel on the card and
how its design deals with that.
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


# ---------------------------------------------------------------------------
# Kernel 1: global attention over (G, S, H*hd)
# ---------------------------------------------------------------------------


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
    idx = torch.arange(s, device=q.device)
    mask = (idx < valid_len)[None, :].expand(s, s)
    if block > 0:
        mask = mask & (idx[:, None] // block == idx[None, :] // block)
    logits = torch.where(mask, logits, torch.full_like(logits, MASK_FILL))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("ghsS,gShd->gshd", weights, vf)
    return out.reshape(g, s, dm).to(q.dtype)


def global_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    block: int = 0, valid_len: int | None = None,
) -> torch.Tensor:
    """Multi-head attention over the natural (G, S, H*hd) layout.

    Per head: softmax((q / sqrt(hd)) k^T) v with q scaled in its dtype, fp32
    softmax and accumulation.  Columns >= ``valid_len`` (default S) are
    masked, and with ``block`` > 0 so is every column outside the row's
    block of ``block`` rows.  Masked logits are -1e30, as in the TPU kernel.
    Returns (G, S, H*hd) in q's dtype.
    """
    if q.device.type == "cpu":
        return global_attention_plain(q, k, v, num_heads, block, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"global_attention runs on CPU or CUDA, not {q.device}")
    g, s, _ = q.shape
    dtype, hd = _check_cuda((q, k, v), num_heads)
    valid_len = s if valid_len is None else valid_len
    if not 0 < valid_len <= s or block < 0:
        raise ValueError(f"valid_len {valid_len} / block {block} out of range for S={s}")
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


global_attention.launches = 0


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
    """
    if qa.device.type == "cpu":
        return local_two_phase_plain(qa, ka, qb, kb, v, num_heads, window)
    if qa.device.type != "cuda":
        raise ValueError(f"local_two_phase runs on CPU or CUDA, not {qa.device}")
    b, p_len, _ = qa.shape
    dtype, hd = _check_cuda((qa, ka, qb, kb, v), num_heads)
    if window != KERNEL_WINDOW or p_len % window:
        raise ValueError(f"the kernel takes window {KERNEL_WINDOW} and P % window == 0, "
                         f"got window {window}, P {p_len}")
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


local_two_phase.launches = 0

KERNELS = (global_attention, local_two_phase)
