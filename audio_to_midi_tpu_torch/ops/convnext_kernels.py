"""The ConvNeXt stage kernels, with their plain versions.

Counterpart of ``audio_to_midi_tpu/ops/pallas_convnext_bwd.py`` (kernel 20)
and ``audio_to_midi_tpu/ops/pallas_convnext.py`` (kernel 19).  A stage is a
chain of ``depth`` blocks over ``x (B, L, C)``: depthwise conv k=7 SAME ->
LayerNorm (fp32, eps 1e-5) -> 1x1 to H -> GELU(tanh) -> 1x1 back -> layer
scale gamma -> + residual.  Both kernels take the stage's weights stacked
over its blocks (:func:`stage_weights`), already in the compute dtype.

* :func:`stage_bwd` -- ``_stage_bwd_pallas``: dx and the fp32 sums of the
  eight weight gradients of all blocks from each block's saved input.
  :func:`stage_blocks_fused_bwd` / :class:`StageBlocksFusedBwd` is the
  ``custom_vjp`` around it: the forward is the plain block loop, which also
  stacks every block's input -- ``depth * B * L * C`` elements, e.g. 86 MB
  for 21 blocks of (32, 500, 128) in bf16 -- and ``cnn_remat`` does not
  change that, as in the JAX package.  CUDA source:
  ``csrc/convnext_stage_bwd.cu``.
* :func:`stage_fwd` -- ``fused_convnext_stage``: the forward of all blocks.
  :func:`fused_convnext_stage` / :class:`FusedConvnextStage` is its
  ``custom_vjp``: it saves the stage's input and differentiates the plain
  block loop from it (rematerializing; not kernel 20).  CUDA source:
  ``csrc/convnext_stage_fwd.cu``.

Both kernels run their products on the tensor cores
(``csrc/convnext_gemm.cuh``: bf16 ``mma.sync``, f32 as 3xTF32), so they
take each product's fp32 sums in another order than their plain versions.

The two kernels round differently, and each plain version mirrors its own:
kernel 20 recomputes the forward as the plain blocks run it in the storage
dtype (conv output rounded before the fp32 LayerNorm; biases, gamma and the
residual applied in the storage dtype), kernel 19 keeps fp32 from the
convolution to the LayerNorm and through each bias and gamma.

Each wrapper takes its plain version only for tensors on the CPU.  On a
CUDA tensor it launches the kernel or raises: f16 raises
``NotImplementedError`` (the models' gates send f16 to autograd, as the JAX
package sends it to XLA), anything else the kernel does not take raises
``ValueError``.  Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import nn as a2m_nn
from . import cuda_build

KERNEL_TAPS = 7
LN_EPS = 1e-5
_GELU_C0 = 0.7978845608028654  # sqrt(2 / pi)
_GELU_C1 = 0.044715
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SHARED_BYTES = 232_448         # what one block may use on an H100
# The order of the stacked weights, and of the gradients stage_bwd returns.
WEIGHT_NAMES = ("dw", "dwb", "ln", "pw1", "pw1b", "pw2", "pw2b", "gamma")


def stage_weights(blocks, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """The blocks of a stage (``models/convnext.Block``s) -> the kernels'
    eight operands, stacked over the blocks and cast to ``dtype``: dw
    (depth, K, C), dwb (depth, 1, C), ln (depth, 2, C) fp32 (scale, bias;
    the values of ``dtype``), pw1 (depth, C, H), pw1b (depth, 1, H), pw2
    (depth, H, C), pw2b and gamma (depth, 1, C).  Differentiable: a gradient
    of an operand flows back to every block's parameter through the cast, so
    under bf16 it is rounded to bf16 on its way to the fp32 parameter."""
    stack = lambda get: torch.stack([get(b) for b in blocks]).to(dtype)
    dw = stack(lambda b: b.depth_conv.w)                       # (depth, K, 1, C)
    return (
        dw.reshape(dw.shape[0], dw.shape[1], dw.shape[3]),
        stack(lambda b: b.depth_conv.b)[:, None, :],
        stack(lambda b: torch.stack([b.norm.scale, b.norm.bias])).float(),
        stack(lambda b: b.pw1.w),
        stack(lambda b: b.pw1.b)[:, None, :],
        stack(lambda b: b.pw2.w),
        stack(lambda b: b.pw2.b)[:, None, :],
        stack(lambda b: b.gamma)[:, None, :],
    )


def plain_block(x: torch.Tensor, weights, d: int) -> torch.Tensor:
    """Block ``d`` of the stacked ``weights`` on x (B, L, C): the same
    operations, bit for bit, as ``models/convnext.block`` without stochastic
    depth."""
    dw, dwb, ln, pw1, pw1b, pw2, pw2b, gamma = weights
    out = a2m_nn.depthwise_conv1d_same(x, dw[d].unsqueeze(1), dwb[d, 0])
    out = a2m_nn.layer_norm(out, ln[d, 0], ln[d, 1])
    out = a2m_nn.linear(out, pw1[d], pw1b[d, 0])
    out = a2m_nn.gelu(out)
    out = a2m_nn.linear(out, pw2[d], pw2b[d, 0])
    return gamma[d, 0].to(out.dtype) * out + x


def plain_stage(x: torch.Tensor, weights) -> torch.Tensor:
    """All blocks in turn, the plain way: what autograd differentiates."""
    for d in range(weights[0].shape[0]):
        x = plain_block(x, weights, d)
    return x


def _shift(x: torch.Tensor, off: int) -> torch.Tensor:
    """(B, L, C): row t takes x[:, t + off], zero outside the sample."""
    if off > 0:
        return F.pad(x[:, off:, :], (0, 0, 0, off))
    if off < 0:
        return F.pad(x[:, :off, :], (0, 0, -off, 0))
    return x


def _depthwise(x32: torch.Tensor, dw: torch.Tensor, dwb: torch.Tensor) -> torch.Tensor:
    """fp32 depthwise conv, SAME: the taps added in order, then the bias."""
    k = dw.shape[0]
    out = torch.zeros_like(x32)
    for j in range(k):
        out = out + _shift(x32, j - k // 2) * dw[j].float()
    return out + dwb.float()


def _normalize(u32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    mean = u32.mean(dim=-1, keepdim=True)
    cent = u32 - mean
    rstd = torch.rsqrt((cent * cent).mean(dim=-1, keepdim=True) + LN_EPS)
    return cent * rstd, rstd


def _rows_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T b over all rows, fp32: (B, L, M), (B, L, N) -> (M, N)."""
    return a.reshape(-1, a.shape[-1]).float().t() @ b.reshape(-1, b.shape[-1]).float()


# ---------------------------------------------------------------------------
# Kernel 20: the backward of a stage
# ---------------------------------------------------------------------------


def stage_bwd_plain(carries: torch.Tensor, weights, dy: torch.Tensor):
    """Plain version of :func:`stage_bwd`: the TPU kernel's body step by step
    in tensor operations, rounding where it rounds.  This is not autograd's
    backward of the blocks, which rounds elsewhere."""
    dw, dwb, ln, pw1, pw1b, pw2, pw2b, gamma = weights
    depth = carries.shape[0]
    k = dw.shape[1]
    dtype = dy.dtype
    grads = [torch.zeros(w.shape, dtype=torch.float32, device=dy.device) for w in weights]
    ddw, ddwb, dln, dpw1, dpw1b, dpw2, dpw2b, dgamma = grads
    sum_rows = lambda t: t.float().sum(dim=(0, 1))
    dx = dy
    for d in reversed(range(depth)):
        x = carries[d]
        x32 = x.float()
        # The forward again: storage dtype, fp32 where the plain blocks are.
        u = _depthwise(x32, dw[d], dwb[d, 0]).to(dtype)
        th, rstd = _normalize(u.float())
        g32 = ln[d, 0]
        t = (th * g32 + ln[d, 1]).to(dtype)
        a = (t.float() @ pw1[d].float()).to(dtype) + pw1b[d, 0]
        af = a.float()
        tanh_u = torch.tanh(_GELU_C0 * (af + _GELU_C1 * af * af * af))
        z = (0.5 * af * (1.0 + tanh_u)).to(dtype)
        s = (z.float() @ pw2[d].float()).to(dtype) + pw2b[d, 0]

        do = dx
        dgamma[d, 0] = sum_rows(do.float() * s.float())
        ds = do * gamma[d, 0]
        dpw2b[d, 0] = sum_rows(ds)
        dpw2[d] = _rows_dot(z, ds)
        dz = (ds.float() @ pw2[d].float().t()).to(dtype)
        sech2 = 1.0 - tanh_u * tanh_u
        gp = 0.5 * (1.0 + tanh_u) + 0.5 * af * sech2 * _GELU_C0 * (1.0 + 3.0 * _GELU_C1 * af * af)
        da = (dz.float() * gp).to(dtype)
        dpw1b[d, 0] = sum_rows(da)
        dpw1[d] = _rows_dot(t, da)
        dt = da.float() @ pw1[d].float().t()
        dln[d, 0] = sum_rows(dt * th)
        dln[d, 1] = sum_rows(dt)
        dth = dt * g32
        m1 = dth.mean(dim=-1, keepdim=True)
        m2 = (dth * th).mean(dim=-1, keepdim=True)
        du32 = rstd * (dth - m1 - th * m2)
        du = du32.to(dtype).float()
        ddwb[d, 0] = sum_rows(du32)
        dxc = torch.zeros_like(du)
        for j in range(k):
            off = j - k // 2
            ddw[d, j] = sum_rows(du * _shift(x32, off))
            dxc = dxc + _shift(du, -off) * dw[d, j].float()
        dx = do + dxc.to(dtype)
    return dx, tuple(grads)


def _check_stage(x: torch.Tensor, weights, what: str) -> tuple[int, int, int]:
    """(depth, hidden, dtype code) of operands the kernels take on the card;
    raises on the rest.  x: (B, L, C)."""
    dtype = x.dtype
    if dtype == torch.float16:
        raise NotImplementedError(f"{what} takes f32 and bf16, not f16")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {dtype}")
    if len(weights) != len(WEIGHT_NAMES):
        raise ValueError(f"{what} takes the {len(WEIGHT_NAMES)} operands of stage_weights")
    dw, _, _, pw1 = weights[:4]
    if x.dim() != 3 or dw.dim() != 3 or pw1.dim() != 3:
        raise ValueError(f"{what}: x must be (B, L, C) and the weights stacked over the blocks")
    (depth, k, c), hidden = dw.shape, pw1.shape[-1]
    shapes = ((depth, k, c), (depth, 1, c), (depth, 2, c), (depth, c, hidden), (depth, 1, hidden),
              (depth, hidden, c), (depth, 1, c), (depth, 1, c))
    for name, w, shape in zip(WEIGHT_NAMES, weights, shapes):
        want = torch.float32 if name == "ln" else dtype
        if (tuple(w.shape) != shape or w.dtype != want or w.device != x.device
                or not w.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous {want} {shape} on {x.device}, "
                             f"got {w.dtype} {tuple(w.shape)} on {w.device}")
    if x.shape[-1] != c or not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous (B, L, {c}), got {tuple(x.shape)}")
    if k != KERNEL_TAPS:
        raise ValueError(f"{what} takes depthwise kernels of {KERNEL_TAPS} taps, got {k}")
    if depth < 1 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{what}: empty stage or input")
    return depth, hidden, _DTYPE_CODES[dtype]


def _workspace(query, what: str, x: torch.Tensor, hidden: int, code: int) -> torch.Tensor:
    b, l, c = x.shape
    need = query(b, l, c, hidden, code)
    if need <= 0:
        raise ValueError(f"{what} does not take B={b}, L={l}, C={c}, H={hidden}")
    return torch.empty(need, dtype=torch.uint8, device=x.device)


def stage_bwd(carries: torch.Tensor, weights, dy: torch.Tensor):
    """The backward of all blocks of a stage.

    carries: (depth, B, L, C), block d's input; dy: (B, L, C), the cotangent
    of the stage's output; ``weights``: :func:`stage_weights` in dy's dtype.
    Returns ``(dx, grads)``: dx (B, L, C) in dy's dtype and the eight weight
    gradients in fp32, shaped and ordered like ``weights``.  Each block's
    forward is recomputed from its input; nothing of size (B, L, H) is kept
    from block to block.  The sums run in a fixed order: the same inputs
    give the same bits."""
    if dy.device.type == "cpu":
        return stage_bwd_plain(carries, weights, dy)
    if dy.device.type != "cuda":
        raise ValueError(f"stage_bwd runs on CPU or CUDA, not {dy.device}")
    depth, hidden, code = _check_stage(dy, weights, "stage_bwd")
    if (carries.shape != (depth, *dy.shape) or carries.dtype != dy.dtype
            or carries.device != dy.device or not carries.is_contiguous()):
        raise ValueError(f"stage_bwd: carries must be contiguous {dy.dtype} "
                         f"{(depth, *dy.shape)} on {dy.device}")
    lib = cuda_build.library()
    workspace = _workspace(lib.a2m_convnext_stage_bwd_workspace, "stage_bwd", dy, hidden, code)
    dx = torch.empty_like(dy)
    grads = tuple(torch.empty(w.shape, dtype=torch.float32, device=dy.device) for w in weights)
    b, l, c = dy.shape
    with torch.cuda.device(dy.device):
        err = lib.a2m_convnext_stage_bwd(
            carries.data_ptr(), dy.data_ptr(), *(w.data_ptr() for w in weights),
            dx.data_ptr(), *(g.data_ptr() for g in grads), workspace.data_ptr(),
            depth, b, l, c, hidden, KERNEL_TAPS, code,
            torch.cuda.current_stream(dy.device).cuda_stream)
    cuda_build.check(err, "stage_bwd")
    stage_bwd.launches += 1
    return dx, grads


class StageBlocksFusedBwd(torch.autograd.Function):
    """All blocks of a stage: the plain block loop forward, which stacks each
    block's input, and :func:`stage_bwd` backward.  Takes x and the eight
    operands of :func:`stage_weights`; returns each gradient in its
    operand's dtype."""

    @staticmethod
    def forward(ctx, x, *weights):
        depth = weights[0].shape[0]
        carries = x.new_empty((depth, *x.shape))
        for d in range(depth):
            carries[d].copy_(x)
            x = plain_block(x, weights, d)
        ctx.save_for_backward(carries, *weights)
        return x

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        carries, *weights = ctx.saved_tensors
        dx, grads = stage_bwd(carries, weights, dy.contiguous())
        return (dx, *(g.to(w.dtype) for g, w in zip(grads, weights)))


def _wants_grad(x: torch.Tensor, weights) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in weights))


def stage_blocks_fused_bwd(x: torch.Tensor, weights) -> torch.Tensor:
    """All blocks of a stage on x (B, L, C), differentiated by kernel 20.
    Where nothing asks for a gradient it is the plain block loop and saves
    nothing."""
    if not _wants_grad(x, weights):
        return plain_stage(x, weights)
    return StageBlocksFusedBwd.apply(x, *weights)


def _bwd_shared_bytes(c: int) -> int:
    """The backward kernel's largest need: two fp32 copies of a row tile."""
    fit = 8192 // c
    return 2 * (32 if fit >= 32 else 16 if fit >= 16 else 8) * c * 4


def stage_bwd_supported(l: int, c: int, hidden: int, depth: int, dtype: torch.dtype) -> bool:
    """Whether a stage's backward goes to kernel 20: everything the JAX
    package's ``bwd_stage_supported`` takes (channels and hidden width
    multiples of 128, ``c * hidden <= 128 Ki``, not f16), for a stage that
    has blocks and rows and whose row tile fits a block's shared memory."""
    return (
        c % 128 == 0 and hidden % 128 == 0 and c * hidden <= 128 * 1024
        and dtype in _DTYPE_CODES
        and depth >= 1 and l >= 1 and _bwd_shared_bytes(c) <= _SHARED_BYTES
    )


# ---------------------------------------------------------------------------
# Kernel 19: the forward of a stage
# ---------------------------------------------------------------------------


def _product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The fp32 sums of a (..., K) . w (K, N), of operands in the storage
    type: the two products of :func:`stage_fwd_plain`."""
    return a.float() @ w.float()


def stage_fwd_plain(x: torch.Tensor, weights) -> torch.Tensor:
    """Plain version of :func:`stage_fwd`, rounding where the TPU kernel
    rounds: fp32 from the convolution through the LayerNorm, biases and gamma
    applied in fp32.  The kernel takes the products' fp32 sums in another
    order (on the tensor cores; f32 as 3xTF32), nothing else."""
    dw, dwb, ln, pw1, pw1b, pw2, pw2b, gamma = weights
    dtype = x.dtype
    for d in range(dw.shape[0]):
        h, _ = _normalize(_depthwise(x.float(), dw[d], dwb[d, 0]))
        h = (h * ln[d, 0] + ln[d, 1]).to(dtype)
        h1 = _product(h, pw1[d]) + pw1b[d, 0].float()
        h1 = F.gelu(h1, approximate="tanh").to(dtype)
        h2 = _product(h1, pw2[d]) + pw2b[d, 0].float()
        x = x + (h2 * gamma[d, 0].float()).to(dtype)
    return x


def stage_fwd(x: torch.Tensor, weights) -> torch.Tensor:
    """The forward of all blocks of a stage: x (B, L, C) -> (B, L, C) with
    ``weights`` = :func:`stage_weights` in x's dtype.  Any L: rows are
    bounds-checked, nothing is padded; any C and H: rows that do not fill
    whole 16-byte pieces take the kernel's element copies.  The sums run in
    a fixed order: the same inputs give the same bits."""
    if x.device.type == "cpu":
        return stage_fwd_plain(x, weights)
    if x.device.type != "cuda":
        raise ValueError(f"stage_fwd runs on CPU or CUDA, not {x.device}")
    depth, hidden, code = _check_stage(x, weights, "stage_fwd")
    lib = cuda_build.library()
    workspace = _workspace(lib.a2m_convnext_stage_fwd_workspace, "stage_fwd", x, hidden, code)
    out = torch.empty_like(x)
    b, l, c = x.shape
    with torch.cuda.device(x.device):
        err = lib.a2m_convnext_stage_fwd(
            x.data_ptr(), *(w.data_ptr() for w in weights), out.data_ptr(),
            workspace.data_ptr(), depth, b, l, c, hidden, KERNEL_TAPS, code,
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "stage_fwd")
    stage_fwd.launches += 1
    return out


class FusedConvnextStage(torch.autograd.Function):
    """:func:`stage_fwd` forward; the backward differentiates the plain block
    loop from the saved stage input (rematerializing), as the JAX package's
    ``fused_convnext_stage_diff`` does."""

    @staticmethod
    def forward(ctx, x, *weights):
        ctx.save_for_backward(x, *weights)
        return stage_fwd(x, weights)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = plain_stage(leaves[0], leaves[1:])
        return torch.autograd.grad(out, leaves, dy)


def fused_convnext_stage(x: torch.Tensor, weights) -> torch.Tensor:
    """All blocks of a stage on x (B, L, C) by kernel 19, differentiable."""
    return FusedConvnextStage.apply(x, *weights)


def stage_fwd_supported(l: int, c: int, depth: int, dtype: torch.dtype) -> bool:
    """Whether a stage's forward goes to kernel 19 under
    ``cnn_impl="pallas_stage"``: the JAX package's ``stage_supported``
    (channels a multiple of 64, at least 8 rows, at least one block) for a
    dtype the kernel takes (not f16)."""
    return c >= 64 and c % 64 == 0 and depth >= 1 and l >= 8 and dtype in _DTYPE_CODES


stage_bwd.launches = 0
stage_fwd.launches = 0

# Every kernel wrapper of this module, for resetting and reading the counts.
KERNELS = (stage_bwd, stage_fwd)
