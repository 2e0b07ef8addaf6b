"""Kernels 3 and 10 of the port -- head-major attention
(``ak.head_major_attention``) and attention with RoPE inside
(``ak.rope_attention``) -- vs the JAX package's ``fused_attention`` and
``fused_rope_attention``, which reach them only through these functions.

On the CPU the wrappers run their plain versions; the JAX side runs its
Pallas kernels in interpret mode, as tests/test_pallas_attention.py and
tests/test_rope_kernel.py do, at their geometries (G 2, H 2, hd 8).  Inputs
come from numpy with a seed.  Tolerances: f32 rtol 1e-4 / atol 1e-5
(tests/test_torch_primitives.close); bf16 forwards 2 ulps of the output's
top binade (the kernels keep the softmax weights in fp32 where the TPU
kernels cast them to bf16 before the product with v).  The bf16 gradients
are tighter, half an ulp: the backward of both packages differentiates the
same reference formulation in the same dtype, so they differ only where an
fp32 sum taken in another order flips a rounding, and differentiating the
kernel's own roundings instead misses by one ulp or more -- the second
assertion of those tests shows that the limit tells the two apart.
tests/test_torch_kernels.py holds the CUDA kernels against the plain
versions on the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu.ops import pallas_attention as pa
from audio_to_midi_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_primitives import close, to_np

torch.set_num_threads(2)

G, H, HD = 2, 2, 8
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def arrays(seed: int, n: int, *shape) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def tables(rows: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX tests' RoPE tables: angle pos * 0.1 * (i + 1)."""
    pos = np.arange(rows)[:, None] * 0.1 * (np.arange(HD // 2)[None, :] + 1)
    return np.cos(pos).astype(np.float32), np.sin(pos).astype(np.float32)


def ulps(out, ref) -> float:
    """Max abs difference in bf16 ulps of the binade of ref's largest magnitude."""
    a, b = to_np(out), to_np(ref)
    ulp = 2.0 ** (math.ceil(math.log2(max(float(np.abs(b).max()), 2.0 ** -100))) - 8)
    return float(np.abs(a - b).max()) / ulp


def assert_matches(out, ref, name: str):
    if name == "f32":
        close(out, ref)
    else:
        assert out.dtype == torch.bfloat16
        assert ulps(out, ref) <= 2


# --- kernel 3: head-major attention ------------------------------------------


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("s,block", [(250, 0), (37, 0), (496, 16), (64, 16)])
def test_head_major_attention_matches_pallas(s, block, name):
    dt, jdt = DTYPES[name]
    q, k, v = arrays(s + block, 3, G, H, s, HD)
    ref = pa.fused_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), block)
    out = ak.head_major_attention(*(torch.from_numpy(x).to(dt) for x in (q, k, v)), block)
    assert out.shape == (G, H, s, HD)
    assert_matches(out, ref, name)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("block", [0, 16])
def test_head_major_reference_is_the_jax_reference(name, block):
    dt, jdt = DTYPES[name]
    q, k, v = arrays(3, 3, G, H, 64, HD)
    ref = pa._xla_reference(*(jnp.asarray(x, jdt) for x in (q, k, v)), block)
    out = ak.head_major_attention_reference(*(torch.from_numpy(x).to(dt) for x in (q, k, v)),
                                            block)
    assert out.dtype == dt
    if name == "f32":
        close(out, ref)
    else:
        assert ulps(out, ref) <= 0.5


# --- kernel 10: attention with RoPE inside -----------------------------------


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("s,block", [(50, 0), (96, 16)])
def test_rope_attention_matches_pallas(s, block, name):
    dt, jdt = DTYPES[name]
    q, k, v = arrays(s, 3, G, s, H * HD)
    cos, sin = tables(128)
    ref = pa.fused_rope_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(cos),
                                  jnp.asarray(sin), H, block)
    out = ak.rope_attention(*(torch.from_numpy(x).to(dt) for x in (q, k, v)),
                            torch.from_numpy(cos), torch.from_numpy(sin), H, block)
    assert out.shape == (G, s, H * HD)
    assert_matches(out, ref, name)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("block", [0, 16])
def test_rope_reference_is_the_jax_reference(name, block):
    dt, jdt = DTYPES[name]
    q, k, v = arrays(4, 3, G, 48, H * HD)
    cos, sin = tables(64)
    ref = pa._rope_attention_reference(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                       jnp.asarray(cos), jnp.asarray(sin), H, block)
    out = ak.rope_attention_reference(*(torch.from_numpy(x).to(dt) for x in (q, k, v)),
                                      torch.from_numpy(cos), torch.from_numpy(sin), H, block)
    assert out.dtype == dt
    if name == "f32":
        close(out, ref)
    else:
        assert ulps(out, ref) <= 0.5


def test_rope_tables_shorter_than_the_sequence_raise():
    q = torch.zeros(1, 40, H * HD)
    cos, sin = (torch.from_numpy(t) for t in tables(39))
    with pytest.raises(ValueError, match="RoPE tables"):
        ak.rope_attention(q, q, q, cos, sin, H)
    with pytest.raises(ValueError, match="RoPE tables"):
        ak.rope_attention_plain(q, q, q, cos, sin, H)


# --- gradients: the backward differentiates the JAX references ---------------


def _grads(kernel, plain, jax_fn, shape, seed: int, name: str):
    """(the port's input gradients, those of autograd through the plain
    version, JAX's) for one fixed cotangent."""
    dt, jdt = DTYPES[name]
    q, k, v, cot = arrays(seed, 4, *shape)
    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    ref = vjp(jnp.asarray(cot, jdt))
    out = []
    for fn in (kernel, plain):
        leaves = [torch.from_numpy(x).to(dt).requires_grad_() for x in (q, k, v)]
        y = fn(*leaves)
        assert y.grad_fn is not None
        out.append(torch.autograd.grad(y, leaves, torch.from_numpy(cot).to(dt)))
    return out[0], out[1], ref


def _assert_grads(mine, through_plain, ref, name: str):
    for g, r in zip(mine, ref):
        if name == "f32":
            close(g, r)
        else:
            assert g.dtype == torch.bfloat16 and ulps(g, r) <= 0.5
    if name == "bf16":
        assert max(ulps(g, r) for g, r in zip(through_plain, ref)) >= 1


@pytest.mark.parametrize("name", DTYPES)
def test_head_major_attention_gradients_match_jax(name):
    mine, plain, ref = _grads(
        ak.head_major_attention, ak.head_major_attention_plain,
        lambda q, k, v: pa.fused_attention(q, k, v, 0), (G, H, 40, HD), 0, name)
    _assert_grads(mine, plain, ref, name)


@pytest.mark.parametrize("name", DTYPES)
def test_rope_attention_gradients_match_jax(name):
    cos, sin = tables(64)
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    mine, plain, ref = _grads(
        lambda q, k, v: ak.rope_attention(q, k, v, tc, ts, H),
        lambda q, k, v: ak.rope_attention_plain(q, k, v, tc, ts, H),
        lambda q, k, v: pa.fused_rope_attention(q, k, v, jnp.asarray(cos), jnp.asarray(sin), H),
        (G, 40, H * HD), 0, name)
    _assert_grads(mine, plain, ref, name)


def test_the_wrappers_count_no_launch_on_the_cpu():
    before = [fn.launches for fn in ak.KERNELS]
    q, k, v = (torch.from_numpy(x) for x in arrays(5, 3, 1, H, 32, HD))
    assert torch.equal(ak.head_major_attention(q, k, v), ak.head_major_attention_plain(q, k, v))
    cos, sin = (torch.from_numpy(t) for t in tables(32))
    flat = [t.transpose(1, 2).reshape(1, 32, H * HD) for t in (q, k, v)]
    assert torch.equal(ak.rope_attention(*flat, cos, sin, H),
                       ak.rope_attention_plain(*flat, cos, sin, H))
    assert [fn.launches for fn in ak.KERNELS] == before
    with pytest.raises(ValueError):
        ak.head_major_attention(*(t.to("meta") for t in (q, k, v)))
