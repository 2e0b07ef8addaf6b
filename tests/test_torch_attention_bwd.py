"""The port's attention backward (plain versions and autograd Functions) vs
the JAX package's backward kernels.

On the CPU the ``*_grads`` wrappers run their plain PyTorch versions; the JAX
side runs ``nhd_grads`` and ``two_phase_grads`` in interpret mode, as
tests/test_pallas_bwd.py does.  Tolerances: f32 rtol 1e-4 / atol 1e-5, the
JAX package's own (tests/test_pallas_bwd.py); bf16 rtol 2e-2 / atol 2e-2 --
both sides round at the same places, but an fp32 difference of one ulp can
flip the bf16 rounding of a weight or a dlogit (relative 2**-8) and of the
output.  tests/test_torch_kernels.py holds the CUDA kernels against these
plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu.ops import pallas_attention as pa
from audio_to_midi_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_primitives import close, rand

torch.set_num_threads(2)

HEADS, HD = 2, 8
TOL = {"f32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def inputs(seed: int, n: int, *shape) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rand(rng, *shape) for _ in range(n)]


def both(arrays, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


# --- kernel 9: global attention backward ------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_bits", [False, True], ids=["nobits", "bits"])
@pytest.mark.parametrize("s,block,valid_len",
                         [(250, 0, 250), (250, 0, 200), (128, 16, 128), (96, 16, 96),
                          (65, 0, 65), (80, 16, 80)])  # ragged: JAX pads S to 128
def test_global_attention_grads_plain_matches_pallas(s, block, valid_len, with_bits, dtype):
    jx, tx = both(inputs(s + block + valid_len, 4, 2, s, HEADS * HD), dtype)
    jbits = tbits = None
    threshold = 0
    if with_bits:
        # The TPU kernel pads S to a multiple of 128 and wants bits of the
        # padded size; the port pads nothing and takes their (S, S) corner.
        s_pad = -(-s // 128) * 128
        bits = np.random.default_rng(s).integers(0, 256, (2, HEADS, s_pad, s_pad), dtype=np.uint8)
        jbits = jnp.asarray(bits)
        tbits = torch.from_numpy(np.ascontiguousarray(bits[:, :, :s, :s]))
        threshold = 26
    ref = pa.nhd_grads(*jx, HEADS, block, valid_len, bits=jbits, threshold=threshold)
    out = ak.global_attention_grads(*tx, HEADS, block, valid_len, tbits, threshold)
    for o, r in zip(out, ref):
        assert o.dtype == DTYPES[dtype][1] and tuple(o.shape) == r.shape
        close(o, r.astype(jnp.float32), **TOL[dtype])


def test_apply_bits_rejects_thresholds_that_keep_all_or_nothing():
    q, k, v, g = (torch.zeros(1, 16, HEADS * HD) for _ in range(4))
    bits = torch.zeros(1, HEADS, 16, 16, dtype=torch.uint8)
    for threshold in (0, 256):
        with pytest.raises(ValueError, match="threshold"):
            ak.global_attention_grads(q, k, v, g, HEADS, bits=bits, threshold=threshold)


# --- kernel 7: two-phase local attention backward ---------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
# 48 and 80: the lengths that cut the card kernel's 64-row blocks short
@pytest.mark.parametrize("p_len", [64, 32, 48, 80])
def test_local_two_phase_grads_plain_matches_pallas(p_len, dtype):
    jx, tx = both(inputs(p_len, 6, 2, p_len, HEADS * HD), dtype)
    ref = pa.two_phase_grads(*jx, HEADS, 16)
    out = ak.local_two_phase_grads(*tx, HEADS, 16)
    assert len(out) == 5
    for o, r in zip(out, ref):
        assert o.dtype == DTYPES[dtype][1]
        close(o, r.astype(jnp.float32), **TOL[dtype])


def test_local_two_phase_grads_edge_rows_have_no_phase_b():
    """A cotangent on the edge rows [0, 8) u [P-8, P) only: phase B sees
    none of it, and phase A sees it unhalved."""
    p_len = 64
    arrays = inputs(5, 6, 2, p_len, HEADS * HD)
    arrays[5][:, 8:p_len - 8] = 0.0
    jx, tx = both(arrays, "f32")
    dqa, dka, dqb, dkb, dv = ak.local_two_phase_grads(*tx, HEADS, 16)
    assert not dqb.any() and not dkb.any()
    assert dqa[:, :16].any() and not dqa[:, 16:p_len - 16].any()
    for o, r in zip((dqa, dka, dqb, dkb, dv), pa.two_phase_grads(*jx, HEADS, 16)):
        close(o, r, **TOL["f32"])


# --- the autograd Functions on the CPU --------------------------------------


def _leaves(arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("s,block,valid_len", [(40, 0, None), (40, 0, 30), (48, 16, 48),
                                               (48, 16, 10)])
def test_global_attention_is_differentiable_like_its_plain_forward(s, block, valid_len):
    q, k, v = _leaves(inputs(s, 3, 2, s, HEADS * HD))
    out = ak.global_attention(q, k, v, HEADS, block, valid_len)
    assert out.grad_fn is not None  # the wrapper does not cut the autograd graph
    cot = torch.from_numpy(inputs(s + 1, 1, 2, s, HEADS * HD)[0])
    grads = torch.autograd.grad(out, (q, k, v), cot)
    refs = torch.autograd.grad(
        ak.global_attention_plain(q, k, v, HEADS, block, valid_len), (q, k, v), cot)
    for got, ref in zip(grads, refs):
        close(got, ref, **TOL["f32"])


def test_local_two_phase_is_differentiable_like_its_plain_forward():
    ts = _leaves(inputs(9, 5, 2, 64, HEADS * HD))
    out = ak.local_two_phase(*ts, HEADS, 16)
    assert out.grad_fn is not None
    cot = torch.from_numpy(inputs(10, 1, 2, 64, HEADS * HD)[0])
    grads = torch.autograd.grad(out, ts, cot)
    refs = torch.autograd.grad(ak.local_two_phase_plain(*ts, HEADS, 16), ts, cot)
    for got, ref in zip(grads, refs):
        close(got, ref, **TOL["f32"])


def test_backward_accepts_a_cotangent_that_is_not_contiguous():
    """The crop after the local core and the reshapes after the global one
    hand backward a strided cotangent."""
    ts = _leaves(inputs(12, 5, 1, 32, HEADS * HD))
    out = ak.local_two_phase(*ts, HEADS, 16)
    wide = torch.from_numpy(inputs(13, 1, 1, 32, 2 * HEADS * HD)[0])
    cot = wide[:, :, ::2]
    assert not cot.is_contiguous()
    grads = torch.autograd.grad(out, ts, cot)
    refs = ak.local_two_phase_grads_plain(*(t.detach() for t in ts), cot.contiguous(), HEADS, 16)
    for got, ref in zip(grads, refs):
        close(got, ref, rtol=0, atol=0)
    loss = ak.global_attention(*ts[:3], HEADS)[:, :25].square().sum()  # a cropped output
    assert all(g is not None for g in torch.autograd.grad(loss, ts[:3]))
