"""The arithmetic of the tensor-core forward of the two-phase local attention
(TPU kernels 2, 5 and 12, ``csrc/local_attention_fwd.cuh``), held on the CPU
before the card holds the kernel.

``tensor_core_local_forward`` below emulates the kernel's order of
operations, window by window: per phase the logits of round_T(q * scale)
against the window's 16 keys in fp32, their fp32 softmax, normalized, the
dropout mask on the normalized weights (kept ones times 256 / (256 -
threshold)), the weights rounded to the working dtype T before their product
with v in fp32, phase B's output zeroed outside [8, P - 8), and (out_a +
out_b) times 0.5 inside that band and 1 outside, in fp32, rounded once.  In
bf16 the rounding of the weights is the TPU kernel's (``_two_phase_core``:
``weights.astype(v_ref.dtype)``), where the port's plain version
``local_two_phase_plain`` keeps fp32 weights.  It is held:

* against the JAX kernels ``fused_local_two_phase`` (kernel 2) and
  ``fused_local_two_phase_dropout`` (kernel 5, on random bytes) in interpret
  mode, as tests/test_torch_attention.py and tests/test_torch_dropout.py run
  them: f32 within rtol 1e-4 / atol 1e-5; bf16 within 1 ulp of the binade of
  the output's largest magnitude, tighter than the 2 ulps the plain version
  needs (tests/test_torch_f16.py) because it rounds where the TPU does;
* for kernel 12, whose TPU generator does not lower on the CPU, on the bytes
  that ``philox_bits_plain`` gives for a seed, through the kernel-5 path;
* against ``local_two_phase_plain`` within the card tolerance of
  tests/test_torch_kernels.py (f32 1e-5, bf16 2e-2 max abs);
* at P = 32, 48, 80, 256, 272 (272 and 80 are not multiples of the kernel's
  64-row block) and head dims 16, 32, 64.

The emulation imports no JAX at module level, so the card tests
(tests/test_torch_kernels.py) import it where JAX is absent; the tests here
import the JAX package inside.  Inputs come from numpy with a seed.
"""

import math

import numpy as np
import pytest
import torch

from audio_to_midi_tpu_torch.ops import attention_kernels as ak

torch.set_num_threads(2)

WINDOW = 16
STRIDE = WINDOW // 2
THRESHOLD = 26  # round(0.1 * 256), the default dropout rate's
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
CARD_TOL = {"f32": 1e-5, "bf16": 2e-2}
P_LENS = (32, 48, 80, 256, 272)
HEAD_DIMS = (16, 32, 64)


def tensor_core_local_forward(qa: torch.Tensor, ka: torch.Tensor, qb: torch.Tensor,
                              kb: torch.Tensor, v: torch.Tensor, num_heads: int,
                              bits_a: torch.Tensor | None = None,
                              bits_b: torch.Tensor | None = None,
                              threshold: int = 0) -> torch.Tensor:
    """The kernel's arithmetic on (B, P, H*hd) tensors in their dtype, with
    the per-phase dropout bytes ``bits_a``, ``bits_b`` ((B, H, P, P) uint8)
    if given; only each row's 16 in-window bytes are read.  On the inputs'
    device (the card tests run it on the card, TF32 off)."""
    b, p_len, dm = qa.shape
    hd = dm // num_heads
    dtype, device = qa.dtype, qa.device
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=dtype, device=device)
    # fp32, as the kernel divides
    keep_inv = torch.tensor(256.0, device=device) / (256 - threshold)
    heads = lambda t: t.reshape(b, p_len, num_heads, hd).transpose(1, 2)  # (B, H, P, hd)

    def phase(q, k, lo, hi, bits):
        """The phase whose windows tile rows [lo, hi); zero elsewhere."""
        n = (hi - lo) // WINDOW
        windows = lambda t: heads(t)[:, :, lo:hi].float().reshape(b, num_heads, n, WINDOW, hd)
        logits = windows(q * scale) @ windows(k).transpose(-1, -2)
        weights = torch.softmax(logits, dim=-1)
        if bits is not None:
            idx = torch.arange(lo, hi, device=device).reshape(n, WINDOW)
            kept = bits[:, :, idx[:, :, None], idx[:, None, :]].to(torch.int32) >= threshold
            weights = torch.where(kept, weights * keep_inv, torch.zeros_like(weights))
        out = torch.zeros(b, num_heads, p_len, hd, device=device)
        out[:, :, lo:hi] = (weights.to(dtype).float() @ windows(v)).reshape(
            b, num_heads, hi - lo, hd)
        return out

    out_a = phase(qa, ka, 0, p_len, bits_a)
    out_b = phase(qb, kb, STRIDE, p_len - STRIDE, bits_b)  # zero outside the band
    rows = torch.arange(p_len, device=device)[:, None]
    mul = torch.where((rows >= STRIDE) & (rows < p_len - STRIDE), 0.5, 1.0)
    out = (out_a + out_b) * mul
    return out.transpose(1, 2).reshape(b, p_len, dm).to(dtype)


def arrays(seed: int, n: int, *shape) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def random_bits(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def ulps(out, ref) -> float:
    """Max abs difference in bf16 ulps of the binade of ref's largest magnitude."""
    a, b = to_np(out), to_np(ref)
    ulp = 2.0 ** (math.ceil(math.log2(max(float(np.abs(b).max()), 2.0 ** -100))) - 8)
    return float(np.abs(a - b).max()) / ulp


def assert_port_vs_jax(out, ref, name: str) -> None:
    if name == "f32":
        np.testing.assert_allclose(to_np(out), to_np(ref), rtol=1e-4, atol=1e-5)
    else:
        assert ulps(out, ref) <= 1


def max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def jax_two_phase(x: list[np.ndarray], name: str, num_heads: int, bits=None):
    """Kernel 2 (``bits`` None) or kernel 5 of the JAX package, in interpret
    mode on the CPU."""
    import jax.numpy as jnp

    from audio_to_midi_tpu.ops import pallas_attention as pa

    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[name]
    jx = [jnp.asarray(a, jdt) for a in x]
    if bits is None:
        return pa.fused_local_two_phase(*jx, num_heads, WINDOW)
    return pa.fused_local_two_phase_dropout(*jx, jnp.asarray(np.asarray(bits[0])),
                                            jnp.asarray(np.asarray(bits[1])), num_heads,
                                            WINDOW, THRESHOLD)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("p_len", P_LENS)
def test_tensor_core_local_arithmetic_matches_jax_kernel_2(p_len, hd, name):
    x = arrays(p_len + hd, 5, 2, p_len, 2 * hd)
    out = tensor_core_local_forward(*(torch.from_numpy(a).to(DTYPES[name]) for a in x), 2)
    assert out.dtype == DTYPES[name]
    assert_port_vs_jax(out, jax_two_phase(x, name, 2), name)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("p_len,hd", [(32, 16), (48, 32), (80, 64), (256, 32), (272, 16)])
def test_tensor_core_local_dropout_arithmetic_matches_jax_kernel_5(p_len, hd, name):
    """Kernel 5 on random bytes; the dropout must show."""
    x = arrays(p_len - hd, 5, 2, p_len, 2 * hd)
    bits = random_bits(p_len * hd, 2, 2, 2, p_len, p_len)
    tx = [torch.from_numpy(a).to(DTYPES[name]) for a in x]
    out = tensor_core_local_forward(*tx, 2, *map(torch.from_numpy, bits), THRESHOLD)
    assert_port_vs_jax(out, jax_two_phase(x, name, 2, bits), name)
    assert max_abs(out, tensor_core_local_forward(*tx, 2)) > 0.05


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("p_len,hd", [(48, 16), (80, 32), (256, 64)])
def test_tensor_core_local_seeded_arithmetic_matches_jax_on_the_plain_philox_bytes(
        p_len, hd, name):
    """Kernel 12: the bytes of a seed (stream (sample, phase * H + head)), as
    ``philox_bits_plain`` draws them, through the JAX kernel-5 path."""
    x = arrays(p_len + 2 * hd, 5, 2, p_len, 2 * hd)
    seed = torch.tensor([p_len, -hd], dtype=torch.int32)
    planes = ak.two_phase_planes(ak.philox_bits_plain(seed, 2, 4, p_len), 2)
    tx = [torch.from_numpy(a).to(DTYPES[name]) for a in x]
    out = tensor_core_local_forward(*tx, 2, *planes, THRESHOLD)
    assert_port_vs_jax(out, jax_two_phase(x, name, 2, [p.numpy() for p in planes]), name)
    # The seeded wrapper's CPU route is the plain version on the same bytes.
    plain = ak.local_two_phase_dropout(*tx, seed, 2, WINDOW, threshold=THRESHOLD)
    assert max_abs(out, plain) <= CARD_TOL[name]


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("source", ["none", "bits", "philox"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("p_len", P_LENS)
def test_tensor_core_local_arithmetic_is_within_the_card_tolerance_of_plain(
        p_len, hd, source, name):
    """What the card tests hold kernels 2, 5 and 12 to, at their geometries
    (4 heads here, 2 at hd 16, as there): the rounding of the weights stays
    inside the limit."""
    heads = 4 if hd > 16 else 2
    tx = [torch.from_numpy(a).to(DTYPES[name]) for a in arrays(p_len * 3 + hd, 5, 2, p_len,
                                                                 heads * hd)]
    if source == "philox":
        seed = torch.tensor([hd, p_len], dtype=torch.int32)
        bits = ak.two_phase_planes(ak.philox_bits_plain(seed, 2, 2 * heads, p_len), heads)
    elif source == "bits":
        bits = tuple(map(torch.from_numpy, random_bits(p_len + hd, 2, 2, heads, p_len, p_len)))
    else:
        bits = (None, None)
    threshold = 0 if source == "none" else THRESHOLD
    out = tensor_core_local_forward(*tx, heads, *bits, threshold)
    ref = ak.local_two_phase_plain(*tx, heads, WINDOW, *bits, threshold)
    assert out.dtype == DTYPES[name] and torch.isfinite(out.float()).all()
    assert max_abs(out, ref) <= CARD_TOL[name]


def test_tensor_core_local_arithmetic_rounds_the_weights_in_bf16_only():
    """The emulation is not the plain version: in bf16 its weights are
    rounded before the product with v, in f32 nothing is."""
    x = arrays(3, 5, 2, 256, 64)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in x]
    f32 = [torch.from_numpy(a) for a in x]
    assert not torch.equal(tensor_core_local_forward(*bf, 1),
                           ak.local_two_phase_plain(*bf, 1, WINDOW))
    assert max_abs(tensor_core_local_forward(*f32, 1),
                   ak.local_two_phase_plain(*f32, 1, WINDOW)) <= 1e-6


@pytest.mark.parametrize("name", DTYPES)
def test_tensor_core_local_arithmetic_edge_rows_have_no_phase_b(name):
    """Rows outside [8, P - 8) are phase A's output alone; with phase B's
    inputs changed, only the band moves."""
    tx = [torch.from_numpy(a).to(DTYPES[name]) for a in arrays(9, 5, 1, 48, 32)]
    out = tensor_core_local_forward(*tx, 2)
    moved = tensor_core_local_forward(tx[0], tx[1], -tx[2], tx[3] * 2, tx[4], 2)
    assert torch.equal(out[:, :STRIDE], moved[:, :STRIDE])
    assert torch.equal(out[:, -STRIDE:], moved[:, -STRIDE:])
    assert max_abs(out[:, STRIDE:-STRIDE], moved[:, STRIDE:-STRIDE]) > 0.05
