"""The attention kernels of the serving and training paths, with their plain
versions.

Counterpart of kernels 1-10 and 12-16 of
``audio_to_midi_tpu/ops/pallas_attention.py``.  As there, one kernel body
serves three sources of the attention-weight dropout mask: none,
precomputed uint8 bits, or bytes drawn inside the kernel from a seed.

* :func:`global_attention` -- ``fused_attention_nhd`` (global layers, and
  the block-diagonal flattened-window fallback of the local layers);
  :func:`global_attention_dropout_bits` -- ``fused_attention_nhd_dropout``;
  :func:`global_attention_dropout` -- ``fused_attention_nhd_dropout_prng``.
  CUDA sources: ``csrc/global_attention.cu`` (the entry),
  ``csrc/global_attention_fwd.cuh`` (the tensor-core body of all three,
  the mask source a template parameter).
* :func:`local_two_phase`, :func:`local_two_phase_dropout_bits`,
  :func:`local_two_phase_dropout` -- ``fused_local_two_phase`` and its
  ``_dropout`` and ``_dropout_prng`` forms (local layers).
  CUDA sources: ``csrc/local_attention.cu`` (the entry),
  ``csrc/local_attention_fwd.cuh`` (the tensor-core body of all three, the
  mask source a template parameter).
* :func:`global_attention_grads` -- ``nhd_grads``: dq, dk, dv of the global
  attention, optionally with the uint8 dropout bits its forward applied;
  :func:`global_attention_grads_prng` -- ``nhd_grads_prng``, with the
  forward's seed.  CUDA source: ``csrc/global_attention_bwd.cu``.
* :func:`local_two_phase_grads`, :func:`local_two_phase_grads_bits`,
  :func:`local_two_phase_grads_prng` -- ``two_phase_grads``,
  ``two_phase_grads_drop``, ``two_phase_grads_drop_prng``: dqa, dka, dqb,
  dkb, dv of the two-phase local attention.
  CUDA source: ``csrc/local_attention_bwd.cu``.
* :func:`philox_bits` -- ``dump_bits_nhd`` / ``dump_bits_two_phase``: the
  mask bytes the seeded kernels draw.  CUDA source: ``csrc/philox_dump.cu``.
* :func:`local_two_phase_rw` -- ``fused_local_two_phase_rw``: the two-phase
  local attention with per-window (16, 16) logit tiles, phase B as phase A
  on rows rolled by the stride (``attention_impl="pallas_rw"``); its
  backward is :func:`local_two_phase_grads`.  It computes kernel 2's
  function, and on the card it is kernel 2: the entry of
  ``csrc/local_attention.cu`` with no mask source, which gives kernel 2's
  bits.
* :func:`head_major_attention` -- ``fused_attention``: attention over the
  head-major (G, H, S, hd) layout, which is :func:`global_attention` on the
  (G*H, S, hd) view with one head; :func:`rope_attention` --
  ``fused_rope_attention``: :func:`global_attention` with the halves-layout
  RoPE of q and k inside.  The JAX package reaches both through these
  functions only, and so does the port.  Their backward is autograd through
  the JAX package's reference formulations (:func:`head_major_attention_reference`,
  :func:`rope_attention_reference`), as its ``custom_vjp``s have it.
  CUDA sources: ``csrc/head_major_attention.cu`` (an entry into kernel 1's
  body), ``csrc/rope_attention.cu`` (the RoPE pass of the fused layers,
  ``csrc/rope_rows.cuh``, into a workspace, then kernel 1's body: kernel
  1's bits on q and k RoPE'd by the plain rotation).

The mask: a weight is kept where its byte ``>= threshold`` and scaled by
``256 / (256 - threshold)``, with ``threshold = round(rate * 256)``, applied
to the normalized fp32 softmax weights.  The seeded kernels draw the byte of
logit (row, column) of stream (sample, core) with Philox4x32-10, key = the
two seed words, counter = (row, column // 16, sample, core): one call gives
the 16 bytes of 16 consecutive columns (``csrc/philox.cuh``).  core is the
head for the global attention and ``phase * H + head`` for the two-phase
local attention.  :func:`philox_bits_plain` computes the same bytes in
integer tensor operations on any device, so a seed gives the same masks on
the CPU and on the card; they are not the TPU generator's.  The seed is a
``(2,)`` int32 tensor on the inputs' device: the kernels read it there, and
nothing waits for the host.

Each wrapper takes the kernel's plain PyTorch version only for tensors on
the CPU.  On a CUDA tensor it launches the kernel or raises: f16 raises
``NotImplementedError`` (the JAX package sends f16 to XLA too, it is a
training loss-scaling policy), and a geometry the kernel does not take
raises ``ValueError``.  Each wrapper counts its launches in ``.launches``.
The source notes in ``csrc/`` say what bounds each kernel on the card and
how its design deals with that.  For the global attention, in short: at the
model's shapes (S = 250, 4 heads x 64) one call moves a few tens of MB and
does a few GFLOP, far below both roofs, so what paces a kernel is how its
products are executed.  Kernels 1, 3, 4 and 15 (the forward without and
with dropout) and 9 and 16 (backward) run their products on the tensor
cores with ``mma.sync`` -- bf16 m16n8k16, f32 as 3xTF32 -- over K / V (or
Q / G) tiles copied by ``cp.async`` into two stages (kernel 4's bits
beside them), a row's softmax statistics in one quad of
lanes, the weights passed from accumulator registers into the next product
(``csrc/mma_tile.cuh``).  In bf16 the forward rounds each tile's
unnormalised weights ``exp(s - m)`` to bf16 before their product with v, as
the TPU kernels round their weights (``weights.astype(v.dtype)``); the plain
versions keep them in fp32, a difference of bf16 rounding.  With dropout
the mask and its scale go on those weights before that rounding.  The local
attention's forward (kernels 2, 5, 12, and 6, which is kernel 2 on the
card) and backward (7, 8, 13) take the same products, one 16 x 16 window per
warp; the forward rounds the normalized, masked weights to bf16, as the TPU
kernel does.  Kernel 10 (RoPE inside) is a RoPE pass over copies of q and
k, then kernel 1's body on them, so it rounds its bf16 weights where kernel
1 does.

The forwards are ``torch.autograd.Function``s on either device: they save
their inputs (and the bits or the seed, never the drawn mask), as the JAX
``custom_vjp``s do, and their backward goes through the ``*_grads``
wrappers -- the plain backward on the CPU, the CUDA backward kernel on the
card, never autograd through the plain forward -- or, for kernels 3 and 10,
through the reference formulations.
"""

from __future__ import annotations

import functools
import math
import os

import torch

from ..models.rope import rope_with
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


def dropout_threshold(rate: float) -> int:
    """The uint8 threshold whose drop rate ``threshold / 256`` is nearest
    ``rate``; the kernels take it only inside (0, 256)."""
    return int(round(rate * 256.0))


def prng_dropout_available() -> bool:
    """Whether attention-weight dropout draws its mask inside the kernels
    (the default).  With ``A2M_PRNG_DROPOUT=0`` in the environment, as in the
    JAX package, the models take the precomputed-bits route instead:
    :func:`philox_bits` writes the same bytes out and the ``*_dropout_bits``
    kernels read them."""
    return os.environ.get("A2M_PRNG_DROPOUT", "1") != "0"


def _check_threshold(threshold: int) -> None:
    if not 0 < threshold < 256:
        raise ValueError(f"dropout threshold {threshold} out of (0, 256)")


def _check_bits(bits: torch.Tensor, shape: tuple[int, ...], like: torch.Tensor) -> None:
    if (bits.dtype != torch.uint8 or bits.device != like.device or not bits.is_contiguous()
            or tuple(bits.shape) != shape):
        raise ValueError(f"bits must be contiguous uint8 {shape} on {like.device}, got "
                         f"{bits.dtype} {tuple(bits.shape)} on {bits.device}")


def _check_seed(seed: torch.Tensor, like: torch.Tensor) -> None:
    if (seed.dtype != torch.int32 or tuple(seed.shape) != (2,) or seed.device != like.device
            or not seed.is_contiguous()):
        raise ValueError(f"the dropout seed must be a (2,) int32 tensor on {like.device}, got "
                         f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")


def _pointer(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _apply_bits(x: torch.Tensor, bits: torch.Tensor, threshold: int) -> torch.Tensor:
    """Inverted dropout from uint8 bits: keep where ``bits >= threshold``,
    kept values scaled by 256 / (256 - threshold).  x: fp32."""
    _check_threshold(threshold)
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
# Kernel 14: the mask bytes of the seeded kernels (Philox4x32-10 by position)
# ---------------------------------------------------------------------------

PHILOX_GROUP = 16  # columns (bytes) per Philox call
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``m * x`` for uint32 values held in
    int64: the product is taken in 16-bit halves of x so that nothing
    exceeds 63 bits."""
    p_lo, p_hi = m * (x & 0xFFFF), m * (x >> 16)
    mid = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (mid >> 32), mid & _U32


def philox4x32_10(counter, key):
    """Philox4x32 with 10 rounds (Salmon et al., Random123).  ``counter``:
    four and ``key``: two broadcastable int64 tensors of uint32 values;
    returns the four output words likewise."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _U32, (k1 + _PHILOX_W1) & _U32
    return c0, c1, c2, c3


def _seed_key(seed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    words = seed.to(torch.int64) & _U32
    return words[0], words[1]


def philox_bits_plain(seed: torch.Tensor, samples: int, cores: int, p_len: int) -> torch.Tensor:
    """Plain version of :func:`philox_bits`, on the seed's device."""
    arange = lambda n: torch.arange(n, dtype=torch.int64, device=seed.device)
    groups = -(-p_len // PHILOX_GROUP)
    counter = (arange(p_len)[:, None], arange(groups)[None, :],
               arange(samples)[:, None, None, None], arange(cores)[None, :, None, None])
    words = torch.stack(torch.broadcast_tensors(*philox4x32_10(counter, _seed_key(seed))), dim=-1)
    octets = (words[..., None] >> (8 * arange(4))) & 255   # (..., groups, word, byte)
    plane = octets.reshape(samples, cores, p_len, groups * PHILOX_GROUP)
    return plane[..., :p_len].to(torch.uint8).contiguous()


def philox_bits(seed: torch.Tensor, samples: int, cores: int, p_len: int) -> torch.Tensor:
    """The dropout mask bytes that the seeded kernels draw for ``seed``:
    (samples, cores, p_len, p_len) uint8.  For the global attention cores =
    H; for the two-phase local attention cores = 2 H, phase A's planes first
    (see :func:`two_phase_planes`)."""
    if seed.device.type == "cpu":
        return philox_bits_plain(seed, samples, cores, p_len)
    if seed.device.type != "cuda":
        raise ValueError(f"philox_bits runs on CPU or CUDA, not {seed.device}")
    _check_seed(seed, seed)
    if min(samples, cores, p_len) <= 0:
        raise ValueError("samples, cores and p_len must be positive")
    out = torch.empty((samples, cores, p_len, p_len), dtype=torch.uint8, device=seed.device)
    lib = cuda_build.library()
    with torch.cuda.device(seed.device):
        code = lib.a2m_philox_dump(seed.data_ptr(), out.data_ptr(), samples, cores, p_len,
                                   _stream_handle(seed.device))
    cuda_build.check(code, "philox_bits")
    philox_bits.launches += 1
    return out


philox_bits.launches = 0


def two_phase_planes(bits: torch.Tensor, num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 2 H, P, P) bytes of the two-phase streams -> contiguous phase-A and
    phase-B planes, each (B, H, P, P)."""
    return bits[:, :num_heads].contiguous(), bits[:, num_heads:].contiguous()


# ---------------------------------------------------------------------------
# Kernels 1, 4, 15 and 9, 16: global attention over (G, S, H*hd)
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
    bits: torch.Tensor | None = None, threshold: int = 0,
) -> torch.Tensor:
    """Plain version of :func:`global_attention` and, with ``bits``
    (G, H, S, S) uint8, of the two dropout forms."""
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
    if bits is not None:
        weights = _apply_bits(weights, bits, threshold)
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


def _check_mask_source(like: torch.Tensor, bits, bits_shape, seed, threshold: int) -> int:
    """Validates the mask source of a CUDA launch; returns the threshold to
    pass on (0 without dropout)."""
    if bits is None and seed is None:
        return 0
    _check_threshold(threshold)
    if seed is not None:
        _check_seed(seed, like)
    for plane in bits or ():
        _check_bits(plane, bits_shape, like)
    return threshold


def _global_forward(wrapper, q, k, v, num_heads: int, block: int, valid_len: int | None,
                    bits=None, seed=None, threshold: int = 0):
    """The global forward with its mask source: none, ``bits`` or ``seed``.
    ``wrapper`` is the public function whose launch this counts as."""
    g, s, _ = q.shape
    if q.device.type == "cpu":
        if seed is not None:
            bits = philox_bits_plain(seed, g, num_heads, s)
        return global_attention_plain(q, k, v, num_heads, block, valid_len, bits, threshold)
    if q.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on CPU or CUDA, not {q.device}")
    dtype, hd = _check_cuda((q, k, v), num_heads)
    valid_len = _check_global(s, block, valid_len)
    threshold = _check_mask_source(q, None if bits is None else (bits,),
                                   (g, num_heads, s, s), seed, threshold)
    out = torch.empty_like(q)
    scale = float(_query_scale(hd, dtype))
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        code = lib.a2m_global_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _pointer(bits), _pointer(seed),
            out.data_ptr(), g, s, num_heads, hd, valid_len, block, threshold, scale,
            _DTYPE_CODES[dtype], _stream_handle(q.device),
        )
    cuda_build.check(code, wrapper.__name__)
    wrapper.launches += 1
    return out


def _global_grads(wrapper, q, k, v, g, num_heads: int, block: int, valid_len: int | None,
                  bits=None, seed=None, threshold: int = 0):
    n, s, _ = q.shape
    if q.device.type == "cpu":
        if seed is not None:
            bits = philox_bits_plain(seed, n, num_heads, s)
        return global_attention_grads_plain(q, k, v, g, num_heads, block, valid_len,
                                            bits, threshold)
    if q.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on CPU or CUDA, not {q.device}")
    dtype, hd = _check_cuda((q, k, v, g), num_heads)
    valid_len = _check_global(s, block, valid_len)
    threshold = _check_mask_source(q, None if bits is None else (bits,),
                                   (n, num_heads, s, s), seed, threshold)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    # Per-row softmax max, 1/sum and sum_c dw.w, written by the dq pass and
    # read by the dk/dv pass.
    stats = torch.empty((n, num_heads, 3, s), dtype=torch.float32, device=q.device)
    scale = float(_query_scale(hd, dtype))
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        code = lib.a2m_global_attention_grads(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), _pointer(bits),
            _pointer(seed), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            n, s, num_heads, hd, valid_len, block, threshold, scale, _DTYPE_CODES[dtype],
            _stream_handle(q.device),
        )
    cuda_build.check(code, wrapper.__name__)
    wrapper.launches += 1
    return dq, dk, dv


def global_attention_grads(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, num_heads: int,
    block: int = 0, valid_len: int | None = None,
    bits: torch.Tensor | None = None, threshold: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`global_attention` for the output cotangent ``g``.

    The softmax is recomputed from q and k; the operands of the five
    products are rounded where the TPU kernel rounds them (see
    :func:`_core_grads`).  ``bits`` (G, H, S, S) uint8 with ``threshold`` in
    (0, 256) are the dropout bits of a forward that applied them
    (:func:`global_attention_dropout_bits`): a weight is kept where
    ``bits >= threshold`` and scaled by 256/(256 - threshold).
    """
    if bits is None:
        threshold = 0
    return _global_grads(global_attention_grads, q, k, v, g, num_heads, block, valid_len,
                         bits=bits, threshold=threshold)


def global_attention_grads_prng(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: torch.Tensor, g: torch.Tensor,
    num_heads: int, block: int = 0, valid_len: int | None = None, *, threshold: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`global_attention_dropout`: the backward draws
    the forward's mask again from ``seed``."""
    return _global_grads(global_attention_grads_prng, q, k, v, g, num_heads, block, valid_len,
                         seed=seed, threshold=threshold)


class _GlobalAttentionFn(torch.autograd.Function):
    """Saves q, k, v and the mask source (bits or seed, if any); the
    backward is :func:`global_attention_grads` or, with a seed,
    :func:`global_attention_grads_prng`."""

    @staticmethod
    def forward(ctx, wrapper, q, k, v, bits, seed, num_heads, block, valid_len, threshold):
        ctx.save_for_backward(q, k, v, bits, seed)
        ctx.geometry = (num_heads, block, valid_len)
        ctx.threshold = threshold
        return _global_forward(wrapper, q, k, v, num_heads, block, valid_len, bits, seed,
                               threshold)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, bits, seed = ctx.saved_tensors
        g = g.contiguous()  # it comes through crops and reshapes and need not be dense
        if seed is not None:
            grads = global_attention_grads_prng(q, k, v, seed, g, *ctx.geometry,
                                                threshold=ctx.threshold)
        else:
            grads = global_attention_grads(q, k, v, g, *ctx.geometry, bits, ctx.threshold)
        return (None, *grads, None, None, None, None, None, None)


def global_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    block: int = 0, valid_len: int | None = None,
) -> torch.Tensor:
    """Multi-head attention over the natural (G, S, H*hd) layout.

    Per head: softmax((q / sqrt(hd)) k^T) v with q scaled in its dtype, fp32
    softmax and accumulation.  Columns >= ``valid_len`` (default S) are
    masked, and with ``block`` > 0 so is every column outside the row's
    block of ``block`` rows.  Masked logits are -1e30, as in the TPU kernel.
    On the card the weights enter their product with v rounded to v's dtype
    (in bf16 the TPU kernel's rounding; the plain version keeps fp32).
    Returns (G, S, H*hd) in q's dtype.  Differentiable in q, k and v.
    """
    return _GlobalAttentionFn.apply(global_attention, q, k, v, None, None, num_heads, block,
                                    valid_len, 0)


def global_attention_dropout_bits(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bits: torch.Tensor, num_heads: int,
    block: int = 0, valid_len: int | None = None, *, threshold: int,
) -> torch.Tensor:
    """:func:`global_attention` with attention-weight dropout from
    precomputed ``bits`` (G, H, S, S) uint8: the normalized fp32 weight at
    (row, column) is kept where its byte ``>= threshold`` and scaled by
    256 / (256 - threshold).  On the card the kept weights enter their
    product with v rounded to v's dtype, as in :func:`global_attention`
    (the scaled unnormalised weight; in bf16 the TPU kernel's
    ``weights.astype(v.dtype)`` after the mask; the plain version keeps
    fp32).  Differentiable in q, k and v."""
    _check_threshold(threshold)
    return _GlobalAttentionFn.apply(global_attention_dropout_bits, q, k, v, bits, None,
                                    num_heads, block, valid_len, threshold)


def global_attention_dropout(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: torch.Tensor, num_heads: int,
    block: int = 0, valid_len: int | None = None, *, threshold: int,
) -> torch.Tensor:
    """:func:`global_attention_dropout_bits` with the bytes drawn inside the
    kernel from ``seed`` ((2,) int32 on q's device), stream (sample, head):
    the bytes :func:`philox_bits` gives for (seed, G, H, S).  Nothing of size
    S x S is stored; the backward draws the mask again.  On the card it is
    the kernel of :func:`global_attention_dropout_bits` with another mask
    source: on those bytes the two give the same bits, the kept weights
    rounded to v's dtype before their product with v."""
    _check_threshold(threshold)
    return _GlobalAttentionFn.apply(global_attention_dropout, q, k, v, None, seed, num_heads,
                                    block, valid_len, threshold)


for _fn in (global_attention, global_attention_dropout_bits, global_attention_dropout,
            global_attention_grads, global_attention_grads_prng):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# Kernels 2, 5, 12 and 7, 8, 13: two-phase local attention over (B, P, H*hd)
# ---------------------------------------------------------------------------


def two_phase_masks(p_len: int, window: int, device):
    """(mask_a, mask_b, b_rows): the P x P window masks of the two phases
    and the (P, 1) rows that have a phase-B window."""
    stride = window // 2
    idx = torch.arange(p_len, device=device)
    rows, cols = idx[:, None], idx[None, :]
    mask_a = torch.div(rows, window, rounding_mode="floor") == torch.div(
        cols, window, rounding_mode="floor")
    in_band = (cols >= stride) & (cols < p_len - stride)
    mask_b = (torch.div(rows - stride, window, rounding_mode="floor")
              == torch.div(cols - stride, window, rounding_mode="floor")) & in_band
    b_rows = ((idx >= stride) & (idx < p_len - stride))[:, None]
    return mask_a, mask_b, b_rows


def local_two_phase_plain(
    qa: torch.Tensor, ka: torch.Tensor, qb: torch.Tensor, kb: torch.Tensor,
    v: torch.Tensor, num_heads: int, window: int,
    bits_a: torch.Tensor | None = None, bits_b: torch.Tensor | None = None,
    threshold: int = 0,
) -> torch.Tensor:
    """Plain version of :func:`local_two_phase` and, with per-phase ``bits``
    (B, H, P, P) uint8, of its two dropout forms: per-phase P x P masked
    attention, as the JAX package's ``_two_phase_reference(_bits)``."""
    b, p_len, dm = qa.shape
    hd = dm // num_heads
    scale = _query_scale(hd, qa.dtype).to(qa.device)
    mask_a, mask_b, b_rows = two_phase_masks(p_len, window, qa.device)
    vh = v.float().reshape(b, p_len, num_heads, hd)

    def mha(q, k, mask, bits):
        qh = (q * scale).float().reshape(b, p_len, num_heads, hd)
        kh = k.float().reshape(b, p_len, num_heads, hd)
        logits = torch.einsum("bshd,bShd->bhsS", qh, kh)
        logits = torch.where(mask, logits, torch.full_like(logits, MASK_FILL))
        weights = torch.softmax(logits, dim=-1)
        if bits is not None:
            weights = _apply_bits(weights, bits, threshold)
        return torch.einsum("bhsS,bShd->bshd", weights, vh).reshape(b, p_len, dm)

    out_a = mha(qa, ka, mask_a, bits_a)
    out_b = mha(qb, kb, mask_b, bits_b)
    out_b = torch.where(b_rows, out_b, torch.zeros_like(out_b))
    inv = torch.where(b_rows, 0.5, 1.0)
    return ((out_a + out_b) * inv).to(qa.dtype)


def local_two_phase_grads_plain(
    qa: torch.Tensor, ka: torch.Tensor, qb: torch.Tensor, kb: torch.Tensor,
    v: torch.Tensor, g: torch.Tensor, num_heads: int, window: int,
    bits_a: torch.Tensor | None = None, bits_b: torch.Tensor | None = None,
    threshold: int = 0,
) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`local_two_phase_grads` and, with per-phase
    ``bits``, of its two dropout forms: per-phase P x P masked cores, as the
    JAX package's ``_two_phase_bwd_core``."""
    p_len = qa.shape[1]
    scale = _query_scale(qa.shape[-1] // num_heads, qa.dtype).to(qa.device)
    mask_a, mask_b, b_rows = two_phase_masks(p_len, window, qa.device)

    # The overlap average first, in fp32; phase B sees no edge rows.
    g_a = g.float() * torch.where(b_rows, 0.5, 1.0)
    g_b = torch.where(b_rows, g_a, torch.zeros_like(g_a))
    vh = _heads(v, num_heads)
    dqa, dka, dva = _core_grads(_heads(qa, num_heads), _heads(ka, num_heads), vh,
                                _heads(g_a, num_heads), mask_a, scale, bits_a, threshold)
    dqb, dkb, dvb = _core_grads(_heads(qb, num_heads), _heads(kb, num_heads), vh,
                                _heads(g_b, num_heads), mask_b, scale, bits_b, threshold)
    return tuple(_unheads(t, qa.dtype) for t in (dqa, dka, dqb, dkb, dva + dvb))


def _check_local(p_len: int, window: int) -> None:
    if window != KERNEL_WINDOW or p_len % window:
        raise ValueError(f"the kernel takes window {KERNEL_WINDOW} and P % window == 0, "
                         f"got window {window}, P {p_len}")


def _seed_planes(seed: torch.Tensor, batch: int, num_heads: int, p_len: int):
    """The per-phase bits a seed stands for, by the plain Philox."""
    return two_phase_planes(philox_bits_plain(seed, batch, 2 * num_heads, p_len), num_heads)


def _local_forward(wrapper, qa, ka, qb, kb, v, num_heads: int, window: int,
                   bits=None, seed=None, threshold: int = 0):
    """The two-phase forward with its mask source: none, ``bits`` = (bits_a,
    bits_b) or ``seed``.  ``wrapper``: the public function this counts as;
    on the CPU :func:`local_two_phase_rw` takes its own plain version."""
    b, p_len, _ = qa.shape
    if qa.device.type == "cpu":
        if wrapper is local_two_phase_rw:
            return local_two_phase_rw_plain(qa, ka, qb, kb, v, num_heads, window)
        if seed is not None:
            bits = _seed_planes(seed, b, num_heads, p_len)
        return local_two_phase_plain(qa, ka, qb, kb, v, num_heads, window,
                                     *(bits or (None, None)), threshold)
    if qa.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on CPU or CUDA, not {qa.device}")
    dtype, hd = _check_cuda((qa, ka, qb, kb, v), num_heads)
    _check_local(p_len, window)
    threshold = _check_mask_source(qa, bits, (b, num_heads, p_len, p_len), seed, threshold)
    bits_a, bits_b = bits or (None, None)
    out = torch.empty_like(qa)
    scale = float(_query_scale(hd, dtype))
    lib = cuda_build.library()
    with torch.cuda.device(qa.device):
        code = lib.a2m_local_two_phase(
            qa.data_ptr(), ka.data_ptr(), qb.data_ptr(), kb.data_ptr(), v.data_ptr(),
            _pointer(bits_a), _pointer(bits_b), _pointer(seed), out.data_ptr(),
            b, p_len, num_heads, hd, threshold, scale, _DTYPE_CODES[dtype],
            _stream_handle(qa.device))
    cuda_build.check(code, wrapper.__name__)
    wrapper.launches += 1
    return out


def _local_grads(wrapper, qa, ka, qb, kb, v, g, num_heads: int, window: int,
                 bits=None, seed=None, threshold: int = 0):
    b, p_len, _ = qa.shape
    if qa.device.type == "cpu":
        if seed is not None:
            bits = _seed_planes(seed, b, num_heads, p_len)
        return local_two_phase_grads_plain(qa, ka, qb, kb, v, g, num_heads, window,
                                           *(bits or (None, None)), threshold)
    if qa.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on CPU or CUDA, not {qa.device}")
    dtype, hd = _check_cuda((qa, ka, qb, kb, v, g), num_heads)
    _check_local(p_len, window)
    threshold = _check_mask_source(qa, bits, (b, num_heads, p_len, p_len), seed, threshold)
    bits_a, bits_b = bits or (None, None)
    outs = tuple(torch.empty_like(qa) for _ in range(5))
    scale = float(_query_scale(hd, dtype))
    lib = cuda_build.library()
    with torch.cuda.device(qa.device):
        code = lib.a2m_local_two_phase_grads(
            qa.data_ptr(), ka.data_ptr(), qb.data_ptr(), kb.data_ptr(), v.data_ptr(),
            g.data_ptr(), _pointer(bits_a), _pointer(bits_b), _pointer(seed),
            *(t.data_ptr() for t in outs),
            b, p_len, num_heads, hd, threshold, scale, _DTYPE_CODES[dtype],
            _stream_handle(qa.device),
        )
    cuda_build.check(code, wrapper.__name__)
    wrapper.launches += 1
    return outs


def local_two_phase_grads(
    qa: torch.Tensor, ka: torch.Tensor, qb: torch.Tensor, kb: torch.Tensor,
    v: torch.Tensor, g: torch.Tensor, num_heads: int, window: int,
) -> tuple[torch.Tensor, ...]:
    """(dqa, dka, dqb, dkb, dv) of :func:`local_two_phase` for the cotangent
    ``g`` of its overlap-averaged output; dv sums both phases in fp32."""
    return _local_grads(local_two_phase_grads, qa, ka, qb, kb, v, g, num_heads, window)


def local_two_phase_grads_bits(
    qa: torch.Tensor, ka: torch.Tensor, qb: torch.Tensor, kb: torch.Tensor,
    v: torch.Tensor, bits_a: torch.Tensor, bits_b: torch.Tensor, g: torch.Tensor,
    num_heads: int, window: int, *, threshold: int,
) -> tuple[torch.Tensor, ...]:
    """The gradients of :func:`local_two_phase_dropout_bits`, with the bits
    its forward applied."""
    return _local_grads(local_two_phase_grads_bits, qa, ka, qb, kb, v, g, num_heads, window,
                        bits=(bits_a, bits_b), threshold=threshold)


def local_two_phase_grads_prng(
    qa: torch.Tensor, ka: torch.Tensor, qb: torch.Tensor, kb: torch.Tensor,
    v: torch.Tensor, seed: torch.Tensor, g: torch.Tensor, num_heads: int, window: int,
    *, threshold: int,
) -> tuple[torch.Tensor, ...]:
    """The gradients of :func:`local_two_phase_dropout`: the backward draws
    the forward's mask again from ``seed``."""
    return _local_grads(local_two_phase_grads_prng, qa, ka, qb, kb, v, g, num_heads, window,
                        seed=seed, threshold=threshold)


class _LocalTwoPhaseFn(torch.autograd.Function):
    """Saves qa, ka, qb, kb, v and the mask source (bits or seed, if any);
    the backward is the matching ``local_two_phase_grads*`` wrapper."""

    @staticmethod
    def forward(ctx, wrapper, qa, ka, qb, kb, v, bits_a, bits_b, seed, num_heads, window,
                threshold):
        ctx.save_for_backward(qa, ka, qb, kb, v, bits_a, bits_b, seed)
        ctx.geometry = (num_heads, window)
        ctx.threshold = threshold
        bits = None if bits_a is None else (bits_a, bits_b)
        return _local_forward(wrapper, qa, ka, qb, kb, v, num_heads, window, bits, seed,
                              threshold)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *inputs, bits_a, bits_b, seed = ctx.saved_tensors
        g = g.contiguous()  # it comes through a crop and need not be dense
        if seed is not None:
            grads = local_two_phase_grads_prng(*inputs, seed, g, *ctx.geometry,
                                               threshold=ctx.threshold)
        elif bits_a is not None:
            grads = local_two_phase_grads_bits(*inputs, bits_a, bits_b, g, *ctx.geometry,
                                               threshold=ctx.threshold)
        else:
            grads = local_two_phase_grads(*inputs, g, *ctx.geometry)
        return (None, *grads, None, None, None, None, None, None)


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
    return _LocalTwoPhaseFn.apply(local_two_phase, qa, ka, qb, kb, v, None, None, None,
                                  num_heads, window, 0)


def local_two_phase_dropout_bits(
    qa: torch.Tensor, ka: torch.Tensor, qb: torch.Tensor, kb: torch.Tensor,
    v: torch.Tensor, bits_a: torch.Tensor, bits_b: torch.Tensor, num_heads: int,
    window: int, *, threshold: int,
) -> torch.Tensor:
    """:func:`local_two_phase` with attention-weight dropout from precomputed
    per-phase ``bits`` (B, H, P, P) uint8: the byte at (row, column) of a
    phase's plane masks that phase's weight of that row for that key.  Only
    the in-window bytes are read.  Differentiable in the five inputs."""
    _check_threshold(threshold)
    return _LocalTwoPhaseFn.apply(local_two_phase_dropout_bits, qa, ka, qb, kb, v, bits_a,
                                  bits_b, None, num_heads, window, threshold)


def local_two_phase_dropout(
    qa: torch.Tensor, ka: torch.Tensor, qb: torch.Tensor, kb: torch.Tensor,
    v: torch.Tensor, seed: torch.Tensor, num_heads: int, window: int, *, threshold: int,
) -> torch.Tensor:
    """:func:`local_two_phase_dropout_bits` with the bytes drawn inside the
    kernel from ``seed`` ((2,) int32 on the inputs' device), stream (sample,
    phase * H + head): the planes ``two_phase_planes(philox_bits(seed, B,
    2 H, P), H)``.  The backward draws the mask again."""
    _check_threshold(threshold)
    return _LocalTwoPhaseFn.apply(local_two_phase_dropout, qa, ka, qb, kb, v, None, None, seed,
                                  num_heads, window, threshold)


# ---------------------------------------------------------------------------
# Kernel 6: the reduced-width two-phase local attention (backward: kernel 7)
# ---------------------------------------------------------------------------


def local_two_phase_rw_plain(
    qa: torch.Tensor, ka: torch.Tensor, qb: torch.Tensor, kb: torch.Tensor,
    v: torch.Tensor, num_heads: int, window: int,
) -> torch.Tensor:
    """Plain version of :func:`local_two_phase_rw`, step by step as the TPU
    body (``_two_phase_kernel_rw`` with ``_blocked_local_core``): per head
    and window a (window, window) logit tile of q scaled in its dtype, the
    fp32 softmax cast to v's dtype, weights . v in fp32.  Phase B is phase A
    on the rows rolled up by the stride; its output is rolled back and zeroed
    outside [stride, P - stride), where the wrapped window lands, and the
    result is (a + b) / 2 inside that range and a outside it."""
    b, p_len, dm = qa.shape
    hd = dm // num_heads
    stride = window // 2
    scale = _query_scale(hd, qa.dtype).to(qa.device)
    tiles = lambda t: t.reshape(b, p_len // window, window, num_heads, hd).float()

    def blocked(q, k, vv):
        logits = torch.einsum("bwshd,bwShd->bwhsS", tiles(q * scale), tiles(k))
        weights = torch.softmax(logits, dim=-1).to(vv.dtype)
        return torch.einsum("bwhsS,bwShd->bwshd", weights.float(), tiles(vv)).reshape(b, p_len, dm)

    up = lambda t: torch.roll(t, -stride, dims=1)
    out_a = blocked(qa, ka, v)
    out_b = torch.roll(blocked(up(qb), up(kb), up(v)), stride, dims=1)
    rows = torch.arange(p_len, device=qa.device)
    b_rows = ((rows >= stride) & (rows < p_len - stride))[:, None]
    out_b = torch.where(b_rows, out_b, torch.zeros_like(out_b))
    inv = torch.where(b_rows, 0.5, 1.0)
    return ((out_a + out_b) * inv).to(qa.dtype)


def local_two_phase_rw(
    qa: torch.Tensor, ka: torch.Tensor, qb: torch.Tensor, kb: torch.Tensor,
    v: torch.Tensor, num_heads: int, window: int,
) -> torch.Tensor:
    """:func:`local_two_phase` as the TPU's reduced-width kernel computes it:
    per-window (16, 16) logit tiles instead of masked rows, phase B as phase
    A on the rows rolled by the stride, and the softmax weights cast to v's
    dtype before their product with v.  The same contract and the same
    backward (:func:`local_two_phase_grads`, kernel 7), as the JAX package's
    ``defvjp`` has it.  Differentiable in all five inputs.

    That is kernel 2's function, value by value, so on the card this
    launches kernel 2's tensor-core body (``csrc/local_attention_fwd.cuh``)
    with no mask source and gives kernel 2's bits; it counts its own
    launches.  The body copies rows 16 bytes at a time: an operand off 16
    bytes raises.  On the CPU it takes its own plain version, which walks the
    TPU body's rolled windows."""
    return _LocalTwoPhaseFn.apply(local_two_phase_rw, qa, ka, qb, kb, v, None, None, None,
                                  num_heads, window, 0)


for _fn in (local_two_phase, local_two_phase_dropout_bits, local_two_phase_dropout,
            local_two_phase_grads, local_two_phase_grads_bits, local_two_phase_grads_prng,
            local_two_phase_rw):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# Kernels 3 and 10: head-major attention and attention with RoPE inside;
# their backward is autograd through the JAX package's references
# ---------------------------------------------------------------------------


class _ReferenceBackwardFn(torch.autograd.Function):
    """``kernel(q, k, v, *tables)`` forward; the backward is autograd
    through ``reference`` on the saved inputs, as the JAX ``custom_vjp``s of
    kernels 3 and 10 differentiate their reference formulations.  The
    tables (RoPE cos and sin) get no gradient."""

    @staticmethod
    def forward(ctx, kernel, reference, q, k, v, *tables):
        ctx.reference = reference
        ctx.save_for_backward(q, k, v, *tables)
        return kernel(q, k, v, *tables)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, *tables = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            out = ctx.reference(*leaves, *tables)
        return (None, None, *torch.autograd.grad(out, leaves, g), *(None for _ in tables))


def head_major_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               block: int = 0) -> torch.Tensor:
    """Plain version of :func:`head_major_attention`: the arithmetic of
    :func:`global_attention_plain` on the head-major layout, equal to it bit
    for bit on the (G*H, S, hd) view with one head."""
    g, h, s, hd = q.shape
    qs = (q * _query_scale(hd, q.dtype).to(q.device)).float()
    logits = qs @ k.float().transpose(-1, -2)
    logits = torch.where(_global_mask(s, block, s, q.device), logits,
                         torch.full_like(logits, MASK_FILL))
    return (torch.softmax(logits, dim=-1) @ v.float()).to(q.dtype)


def head_major_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   block: int = 0) -> torch.Tensor:
    """The JAX package's ``_xla_reference``, which kernel 3's backward
    differentiates: everything in fp32 (q / sqrt(hd) too), the output cast
    to q's dtype."""
    s, hd = q.shape[-2:]
    logits = (q.float() / math.sqrt(hd)) @ k.float().transpose(-1, -2)
    if block > 0:
        logits = torch.where(_global_mask(s, block, s, q.device), logits,
                             torch.full_like(logits, MASK_FILL))
    return (torch.softmax(logits, dim=-1) @ v.float()).to(q.dtype)


def _head_major_forward(q, k, v, block: int):
    g, h, s, hd = q.shape
    if q.device.type == "cpu":
        return head_major_attention_plain(q, k, v, block)
    if q.device.type != "cuda":
        raise ValueError(f"head_major_attention runs on CPU or CUDA, not {q.device}")
    dtype, hd = _check_cuda((q, k, v), 1)
    _check_global(s, block, None)
    if g * h > 65535:  # kernel 1's body on G*H samples of one head: the grid's z
        raise ValueError(f"at most 65535 (sample, head) pairs per call, got {g} x {h}")
    out = torch.empty_like(q)
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        code = lib.a2m_head_major_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g, h, s, hd, block,
            float(_query_scale(hd, dtype)), _DTYPE_CODES[dtype], _stream_handle(q.device))
    cuda_build.check(code, "head_major_attention")
    head_major_attention.launches += 1
    return out


def head_major_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         block: int = 0) -> torch.Tensor:
    """Multi-head attention over the head-major (G, H, S, hd) layout:
    :func:`global_attention`'s arithmetic, every column < S, and with
    ``block`` > 0 only the columns of the row's block of ``block`` rows.
    Returns (G, H, S, hd) in q's dtype.  Differentiable in q, k and v: the
    backward is autograd through :func:`head_major_attention_reference`."""
    return _ReferenceBackwardFn.apply(
        functools.partial(_head_major_forward, block=block),
        functools.partial(head_major_attention_reference, block=block), q, k, v)


def _check_tables(cos: torch.Tensor, sin: torch.Tensor, s: int, hd: int) -> None:
    for t in (cos, sin):
        if t.dim() != 2 or t.shape[0] < s or t.shape[1] != hd // 2:
            raise ValueError(f"RoPE tables must be (>= {s}, {hd // 2}), got {tuple(t.shape)}")


def _rope_rows(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               num_heads: int) -> torch.Tensor:
    """(G, S, H*hd) -> the halves-layout RoPE of each head in fp32, cast back,
    as (G, S, H, hd)."""
    g, s, dm = t.shape
    return rope_with(t.reshape(g, s, num_heads, dm // num_heads), cos[:s].float(),
                     sin[:s].float())


def rope_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor, num_heads: int, block: int = 0) -> torch.Tensor:
    """Plain version of :func:`rope_attention`: q and k rotated in fp32 and
    cast back to their dtype, then :func:`global_attention_plain`."""
    _check_tables(cos, sin, q.shape[1], q.shape[2] // num_heads)
    rot = lambda t: _rope_rows(t, cos, sin, num_heads).reshape(t.shape)
    return global_attention_plain(rot(q), rot(k), v, num_heads, block)


def rope_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             cos: torch.Tensor, sin: torch.Tensor, num_heads: int,
                             block: int = 0) -> torch.Tensor:
    """The JAX package's ``_rope_attention_reference``, which kernel 10's
    backward differentiates: the rotation cast to the dtype, q / sqrt(hd) in
    the dtype, the logits computed in the dtype and then widened, the fp32
    softmax cast to v's dtype, weights . v in the dtype."""
    g, s, dm = q.shape
    hd = dm // num_heads
    qh = _rope_rows(q, cos, sin, num_heads) / torch.tensor(math.sqrt(hd), dtype=q.dtype,
                                                         device=q.device)
    kh = _rope_rows(k, cos, sin, num_heads)
    logits = torch.einsum("gshd,gShd->ghsS", qh, kh).float()
    if block > 0:
        logits = torch.where(_global_mask(s, block, s, q.device), logits,
                             torch.full_like(logits, MASK_FILL))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("ghsS,gShd->gshd", weights, v.reshape(g, s, num_heads, hd))
    return out.reshape(g, s, dm)


def _rope_forward(q, k, v, cos, sin, num_heads: int, block: int):
    g, s, _ = q.shape
    if q.device.type == "cpu":
        return rope_attention_plain(q, k, v, cos, sin, num_heads, block)
    if q.device.type != "cuda":
        raise ValueError(f"rope_attention runs on CPU or CUDA, not {q.device}")
    dtype, hd = _check_cuda((q, k, v), num_heads)
    _check_global(s, block, None)
    tables = [t[:s].to(device=q.device, dtype=torch.float32).contiguous() for t in (cos, sin)]
    out = torch.empty_like(q)
    workspace = torch.empty((2, *q.shape), dtype=dtype, device=q.device)  # RoPE'd q, k
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        code = lib.a2m_rope_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(),
            workspace.data_ptr(), out.data_ptr(), g, s, num_heads, hd, block,
            float(_query_scale(hd, dtype)), _DTYPE_CODES[dtype], _stream_handle(q.device))
    cuda_build.check(code, "rope_attention")
    rope_attention.launches += 1
    return out


def rope_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, num_heads: int, block: int = 0) -> torch.Tensor:
    """:func:`global_attention` on q and k that arrive unroped: each head's
    halves-layout rotation by the rows of ``cos`` and ``sin`` ((>= S, hd/2),
    taken in fp32) runs in fp32 and is cast back to the dtype, then q is
    scaled by 1/sqrt(hd) in its dtype.  Columns >= S are masked, and with
    ``block`` > 0 every column outside the row's block.  Returns (G, S,
    H*hd) in q's dtype.  Differentiable in q, k and v: the backward is
    autograd through :func:`rope_attention_reference`."""
    _check_tables(cos, sin, q.shape[1], q.shape[2] // num_heads)
    return _ReferenceBackwardFn.apply(
        functools.partial(_rope_forward, num_heads=num_heads, block=block),
        functools.partial(rope_attention_reference, num_heads=num_heads, block=block),
        q, k, v, cos, sin)


head_major_attention.launches = 0
rope_attention.launches = 0

# Every kernel wrapper, for resetting and reading the launch counts: the four
# dropout-free ones first, then the seeded ones, the bits ones and the dump,
# then kernels 6, 3 and 10.
KERNELS = (
    global_attention, local_two_phase, global_attention_grads, local_two_phase_grads,
    global_attention_dropout, local_two_phase_dropout,
    global_attention_grads_prng, local_two_phase_grads_prng,
    global_attention_dropout_bits, local_two_phase_dropout_bits, local_two_phase_grads_bits,
    philox_bits, local_two_phase_rw, head_major_attention, rope_attention,
)
