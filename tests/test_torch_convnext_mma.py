"""The arithmetic of the tensor-core ConvNeXt stage forward (TPU kernel 19,
``csrc/convnext_stage_fwd.cu``), held on the CPU before the card holds the
kernel.

The kernel keeps every rounding of its plain version: the convolution and
the LayerNorm in fp32 in the same order (the same bits of t), bias + GELU
in fp32 then rounded, (sum + bias) * gamma in fp32 then rounded, the
residual added in the storage type.  What moves is the order of each
product's fp32 sum: ``mma_gemm_kernel`` adds depth steps of 16 (bf16) or 8
(f32, as 3xTF32).  ``tensor_core_stage`` swaps that order, the emulation of
tests/test_torch_fused_mma.py (``product``), into the plain version's two
products (``ck._product``), and the result is held:

* against the JAX kernel 19 (``fused_convnext_stage``) in interpret mode,
  as tests/test_torch_convnext_kernels.py runs it: f32 within that file's
  rtol 2e-5 / atol 2e-6 (the JAX package's own), bf16 within the card limit
  of tests/test_torch_kernels.py (``_stage_limit``: 3 ulps of the output's
  top binade for up to 3 blocks), since both round at the same places and
  differ only in the order of fp32 sums;
* against the plain version within that same card limit, which the kernel
  is held to on the card.

The geometries: C 64 / 128, H 128 / 256, and H 196, whose bf16 rows (392
bytes) do not fill whole 16-byte pieces -- the kernel's element copies --
at depth 2-3 and L 37-40 (a length that no tile divides).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu.ops import pallas_convnext as jax_stage_fwd
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.ops import convnext_kernels as ck
from tests.test_torch_convnext_kernels import DTYPES, as_np, stage_blocks, to_jax, to_torch
from tests.test_torch_fused_mma import product
from tests.test_torch_kernels import _stage_limit
from tests.test_torch_primitives import rand

torch.set_num_threads(2)

# (depth, B, L, C, H)
GEOMETRIES = [(3, 2, 40, 64, 128), (2, 2, 37, 128, 256), (2, 2, 38, 64, 196)]


@contextlib.contextmanager
def tensor_core_stage():
    """Inside, ``ck.stage_fwd_plain`` takes its products in the kernel's
    order."""
    plain = ck._product
    ck._product = product
    try:
        yield
    finally:
        ck._product = plain


def emulated_stage_fwd(x: torch.Tensor, weights) -> torch.Tensor:
    with torch.no_grad(), tensor_core_stage():
        return ck.stage_fwd_plain(x, weights)


def _operands(depth, b, l, c, hidden, name, seed):
    """Seeded numpy blocks and x, and the port's operands of them."""
    tdt, _ = DTYPES[name]
    blocks = stage_blocks(seed, depth, c, hidden)
    x = rand(np.random.default_rng(seed + 1), b, l, c)
    weights = tuple(w.detach() for w in
                    ck.stage_weights(convert.stage_blocks_from_jax(blocks), tdt))
    return blocks, x, to_torch(x, tdt), weights


def test_the_swap_reaches_the_plain_products_and_is_undone():
    _, _, x, weights = _operands(2, 2, 37, 64, 128, "f32", 5)
    plain = ck.stage_fwd_plain(x, weights)
    emulated = emulated_stage_fwd(x, weights)
    assert ck._product is not product
    assert not torch.equal(emulated, plain)   # 3xTF32 sums differ in their last bits
    assert (emulated - plain).abs().max().item() <= 2e-5 * plain.abs().max().item()
    assert torch.equal(ck.stage_fwd_plain(x, weights), plain)


@pytest.mark.parametrize("name", ["bf16", "f32"])
@pytest.mark.parametrize("depth,b,l,c,hidden", GEOMETRIES)
def test_tensor_core_order_matches_the_pallas_kernel(name, depth, b, l, c, hidden):
    tdt, jdt = DTYPES[name]
    blocks, x_np, x, weights = _operands(depth, b, l, c, hidden, name, 30 + hidden)
    ref = jax_stage_fwd.fused_convnext_stage(
        jnp.asarray(x_np).astype(jdt), jax_stage_fwd.stage_weights(to_jax(blocks, jdt), jdt))
    out = emulated_stage_fwd(x, weights)
    assert out.dtype == tdt and out.shape == (b, l, c)
    if name == "f32":
        np.testing.assert_allclose(as_np(out), as_np(ref), rtol=2e-5, atol=2e-6)
    else:
        ref_t = torch.tensor(as_np(ref))
        assert (out.float() - ref_t).abs().max().item() <= _stage_limit(ref_t, tdt, depth)


@pytest.mark.parametrize("name", ["bf16", "f32"])
@pytest.mark.parametrize("depth,b,l,c,hidden", GEOMETRIES)
def test_tensor_core_order_is_within_the_card_limit_of_plain(name, depth, b, l, c, hidden):
    tdt, _ = DTYPES[name]
    _, _, x, weights = _operands(depth, b, l, c, hidden, name, 50 + hidden)
    ref = ck.stage_fwd_plain(x, weights)
    out = emulated_stage_fwd(x, weights)
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= _stage_limit(ref, tdt, depth)
