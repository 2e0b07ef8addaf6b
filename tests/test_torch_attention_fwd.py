"""The arithmetic of the tensor-core forward of the global attention (TPU
kernels 1, 3, 4 and 15, ``csrc/global_attention_fwd.cuh``), held on the CPU
before the card holds the kernel.

* Kernel 3 is kernel 1 on another view: ``head_major_attention_plain`` of a
  (G, H, S, hd) tensor equals ``global_attention_plain`` of its (G*H, S, hd)
  view with one head, bit for bit.
* ``tensor_core_forward`` below emulates, in this file only, the kernel's
  order of operations: 64-column key tiles, an online softmax, each tile's
  unnormalised weights ``exp(s - m)`` rounded to the working dtype before
  their product with v, and the division by the fp32 row sum at the end.  In
  bf16 that rounding is the TPU kernels' (``weights.astype(v.dtype)``), where
  the port's plain versions keep fp32 weights.  The emulation is held
  against the JAX kernels ``fused_attention_nhd`` and ``fused_attention``
  in interpret mode, as tests/test_torch_attention.py and
  tests/test_torch_attention_variants.py run them, within those files'
  port-vs-JAX tolerances (f32: rtol 1e-4 / atol 1e-5; bf16: 2 ulps of the
  output's top binade), and against ``global_attention_plain`` within the
  card tolerance of tests/test_torch_kernels.py (f32 1e-5, bf16 2e-2 max
  abs), at the card tests' geometries.
* With a dropout mask source (kernels 4 and 15) the emulation applies the
  mask and its 256 / (256 - threshold) to each tile's unnormalised weights
  before their rounding, while the row sum stays unmasked.  It is held
  against the JAX kernel 4 ``fused_attention_nhd_dropout`` in interpret
  mode, as tests/test_torch_dropout.py runs it, and against
  ``global_attention_plain`` with the bits within the card tolerance, on
  random bytes (kernel 4) and on the bytes ``philox_bits_plain`` gives for a
  seed (kernel 15, whose TPU counterpart draws from a generator that does
  not lower on the CPU).

Inputs come from numpy with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu.ops import pallas_attention as pa
from audio_to_midi_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_attention_variants import ulps
from tests.test_torch_primitives import close

torch.set_num_threads(2)

TILE = 64  # key columns per step of the kernel's online softmax
THRESHOLD = 26  # round(0.1 * 256), the default dropout rate's
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
CARD_TOL = {"f32": 1e-5, "bf16": 2e-2}


def arrays(seed: int, *shape) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def tensor_core_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                        block: int = 0, valid_len: int | None = None,
                        bits: torch.Tensor | None = None, threshold: int = 0) -> torch.Tensor:
    """The kernel's arithmetic on (G, S, H*hd) tensors in their dtype, with
    the dropout ``bits`` (G, H, S, S) uint8 if given.  It walks every key
    tile: a tile the kernel skips holds only columns that are masked for
    every row of the query tile, and such a row also sees a visible column,
    so the skipped tile's weights exp(-1e30 - m) are 0, dropped or not."""
    g, s, dm = q.shape
    hd = dm // num_heads
    valid_len = s if valid_len is None else valid_len
    heads = lambda t: t.reshape(g, s, num_heads, hd).transpose(1, 2).float()
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=q.dtype)
    logits = heads(q * scale) @ heads(k).transpose(-1, -2)
    cols = torch.arange(s)
    mask = (cols < valid_len)[None, :].expand(s, s)
    if block > 0:
        mask = mask & (cols[:, None] // block == cols[None, :] // block)
    logits = torch.where(mask, logits, torch.full_like(logits, ak.MASK_FILL))
    vf = heads(v)
    keep_inv = torch.tensor(256.0) / (256 - threshold)  # fp32, as the kernel divides
    m = torch.full((g, num_heads, s, 1), -torch.inf)
    row_sum = torch.zeros(g, num_heads, s, 1)
    acc = torch.zeros(g, num_heads, s, hd)
    for k0 in range(0, s, TILE):
        tile = logits[..., k0:k0 + TILE]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(tile - m_new)
        row_sum = row_sum * alpha + p.sum(-1, keepdim=True)
        if bits is not None:
            kept = bits[..., k0:k0 + TILE].to(torch.int32) >= threshold
            p = torch.where(kept, p * keep_inv, torch.zeros_like(p))
        acc = acc * alpha + p.to(v.dtype).float() @ vf[..., k0:k0 + TILE, :]
        m = m_new
    return (acc / row_sum).transpose(1, 2).reshape(g, s, dm).to(q.dtype)


def assert_port_vs_jax(out, ref, name: str):
    if name == "f32":
        close(out, ref)
    else:
        assert ulps(out, ref) <= 2


def max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("s,block", [(37, 0), (37, 16), (250, 0), (250, 16)])
def test_head_major_plain_is_global_plain_of_the_view(s, block, name):
    dt = DTYPES[name][0]
    q, k, v = (torch.from_numpy(x).to(dt) for x in arrays(s + block, 2, 3, s, 16))
    out = ak.head_major_attention_plain(q, k, v, block)
    flat = ak.global_attention_plain(*(t.reshape(6, s, 16) for t in (q, k, v)), 1, block)
    assert torch.equal(out, flat.reshape(2, 3, s, 16))


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("s,block", [(250, 0), (37, 0), (496, 16)])
def test_tensor_core_arithmetic_matches_jax_kernel_1(s, block, name):
    dt, jdt = DTYPES[name]
    q, k, v = arrays(s + block, 2, s, 2 * 16)
    ref = pa.fused_attention_nhd(*(jnp.asarray(x, jdt) for x in (q, k, v)), 2, block)
    out = tensor_core_forward(*(torch.from_numpy(x).to(dt) for x in (q, k, v)), 2, block)
    assert out.dtype == dt
    assert_port_vs_jax(out, ref, name)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("s,block", [(250, 0), (37, 0), (496, 16), (64, 16)])
def test_tensor_core_arithmetic_matches_jax_kernel_3(s, block, name):
    """Kernel 3 as the card runs it: kernel 1's body on the (G*H, S, hd)
    view with one head."""
    dt, jdt = DTYPES[name]
    q, k, v = arrays(s + block, 2, 2, s, 8)
    ref = pa.fused_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), block)
    out = tensor_core_forward(*(torch.from_numpy(x).to(dt).reshape(4, s, 8) for x in (q, k, v)),
                              1, block)
    assert_port_vs_jax(out.reshape(2, 2, s, 8), ref, name)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("s,block,valid,hd", [
    (1, 0, 1, 64), (37, 0, 37, 64), (64, 0, 64, 64), (65, 0, 65, 64), (250, 0, 250, 64),
    (250, 0, 200, 64), (496, 16, 496, 64), (80, 16, 40, 64), (250, 0, 250, 32),
    (250, 0, 250, 16),
])
def test_tensor_core_arithmetic_is_within_the_card_tolerance_of_plain(s, block, valid, hd, name):
    """What the card tests hold the kernel to, at their geometries (4
    windows here): the rounding of the weights stays inside the limit."""
    dt = DTYPES[name][0]
    heads = 4 if hd > 16 else 2
    q, k, v = (torch.from_numpy(x).to(dt) for x in arrays(s + valid + hd, 4, s, heads * hd))
    out = tensor_core_forward(q, k, v, heads, block, valid)
    ref = ak.global_attention_plain(q, k, v, heads, block, valid)
    assert out.dtype == dt and torch.isfinite(out.float()).all()
    assert max_abs(out, ref) <= CARD_TOL[name]


def test_tensor_core_arithmetic_rounds_the_weights_in_bf16_only():
    """The emulation is not the plain version: in bf16 its weights are
    rounded before the product with v, in f32 nothing is."""
    q, k, v = arrays(3, 2, 250, 64)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    f32 = [torch.from_numpy(x) for x in (q, k, v)]
    assert not torch.equal(tensor_core_forward(*bf, 1), ak.global_attention_plain(*bf, 1))
    assert max_abs(tensor_core_forward(*f32, 1), ak.global_attention_plain(*f32, 1)) <= 1e-6


@pytest.mark.parametrize("name", DTYPES)
def test_tensor_core_arithmetic_averages_a_fully_masked_row(name):
    """Rows whose whole block lies past valid_len average all S columns."""
    dt = DTYPES[name][0]
    q, k, v = (torch.from_numpy(x).to(dt) for x in arrays(5, 1, 80, 16))
    out = tensor_core_forward(q, k, v, 1, block=16, valid_len=40)
    rows = out[0, 48:].float()  # blocks starting at 48 and 64 hold no column < 40
    mean = v[0].float().mean(0).expand_as(rows)
    assert (rows - mean).abs().max().item() <= (1e-6 if name == "f32" else 2e-2)


DROPOUT_CASES = [(250, 0, 250), (37, 0, 37), (496, 16, 496), (80, 16, 40)]


def random_bits(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("s,block,valid", DROPOUT_CASES)
def test_tensor_core_dropout_arithmetic_matches_jax_kernel_4(s, block, valid, name):
    """Kernel 4 as the card runs it, against the TPU kernel on the same
    bytes (interpret mode takes S as it is: no padding)."""
    dt, jdt = DTYPES[name]
    q, k, v = arrays(s + valid, 1, s, 2 * 16)
    bits = random_bits(s + block, 1, 2, s, s)
    ref = pa.fused_attention_nhd_dropout(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                         jnp.asarray(bits), 2, block, THRESHOLD, valid)
    out = tensor_core_forward(*(torch.from_numpy(x).to(dt) for x in (q, k, v)), 2, block,
                              valid, torch.from_numpy(bits), THRESHOLD)
    assert out.dtype == dt
    assert_port_vs_jax(out, ref, name)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("source", ["bits", "philox"])
@pytest.mark.parametrize("s,block,valid", DROPOUT_CASES)
def test_tensor_core_dropout_arithmetic_is_within_the_card_tolerance_of_plain(
        s, block, valid, source, name):
    """What the card tests hold kernels 4 and 15 to, at their geometries (2
    windows, 4 heads x 64 here): random bytes for kernel 4, the plain
    Philox's bytes of a seed for kernel 15; the dropout must show."""
    dt = DTYPES[name][0]
    q, k, v = (torch.from_numpy(x).to(dt) for x in arrays(s + valid, 2, s, 4 * 64))
    if source == "philox":
        bits = ak.philox_bits_plain(torch.tensor([s, valid], dtype=torch.int32), 2, 4, s)
    else:
        bits = torch.from_numpy(random_bits(s, 2, 4, s, s))
    out = tensor_core_forward(q, k, v, 4, block, valid, bits, THRESHOLD)
    ref = ak.global_attention_plain(q, k, v, 4, block, valid, bits, THRESHOLD)
    assert out.dtype == dt and torch.isfinite(out.float()).all()
    assert max_abs(out, ref) <= CARD_TOL[name]
    assert max_abs(out, ak.global_attention_plain(q, k, v, 4, block, valid)) > 10 * CARD_TOL[name]
