"""The kernel wrappers of the PyTorch port (attention, then the ConvNeXt
stage kernels), without JAX.

This file imports no JAX, so it also runs where only PyTorch is installed.
On the CPU it checks the wrappers' routing; the ``cuda``-marked tests hold
each CUDA kernel against its plain version on the card and skip where there
is no CUDA device.  On a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

(``--noconftest``: the repository's conftest configures JAX.)
"""

import dataclasses
import functools
import math

import pytest
import torch

from audio_to_midi_tpu_torch.ops import attention_kernels as ak
from audio_to_midi_tpu_torch.ops import convnext_kernels as ck

torch.set_num_threads(2)


def _randn(*shape, seed: int, device="cpu", dtype=torch.float32) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(*shape, generator=gen).to(device=device, dtype=dtype)


def test_wrappers_on_cpu_take_the_plain_version_and_count_nothing():
    before = [fn.launches for fn in ak.KERNELS]
    q, k, v = (_randn(1, 64, 32, seed=i) for i in range(3))
    torch.testing.assert_close(ak.global_attention(q, k, v, 2),
                               ak.global_attention_plain(q, k, v, 2), rtol=0, atol=0)
    torch.testing.assert_close(ak.local_two_phase(q, k, q, k, v, 2, 16),
                               ak.local_two_phase_plain(q, k, q, k, v, 2, 16),
                               rtol=0, atol=0)
    assert [fn.launches for fn in ak.KERNELS] == before


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 16, 32, device="meta")
    with pytest.raises(ValueError):
        ak.global_attention(q, q, q, 2)
    with pytest.raises(ValueError):
        ak.local_two_phase(q, q, q, q, q, 2, 16)
    with pytest.raises(ValueError):
        ak.global_attention_grads(q, q, q, q, 2)
    with pytest.raises(ValueError):
        ak.local_two_phase_grads(q, q, q, q, q, q, 2, 16)


def test_grads_wrappers_on_cpu_take_the_plain_version_and_count_nothing():
    before = [fn.launches for fn in ak.KERNELS]
    q, k, v, g = (_randn(1, 64, 32, seed=i) for i in range(4))
    for out, ref in zip(ak.global_attention_grads(q, k, v, g, 2, 16, 40),
                        ak.global_attention_grads_plain(q, k, v, g, 2, 16, 40)):
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for out, ref in zip(ak.local_two_phase_grads(q, k, q, k, v, g, 2, 16),
                        ak.local_two_phase_grads_plain(q, k, q, k, v, g, 2, 16)):
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert [fn.launches for fn in ak.KERNELS] == before
    assert len(ak.KERNELS) == 15


def test_global_attention_grads_of_fully_masked_rows():
    """A fully masked row has uniform weights: it gives dv its cotangent
    over S and gives dq and dk nothing."""
    q, k, v, g = (_randn(1, 40, 16, seed=11 + i) for i in range(4))
    g[:, :16] = 0  # only the fully masked rows (blocks that hold no column < 10) push back
    dq, dk, dv = ak.global_attention_grads_plain(q, k, v, g, 1, block=16, valid_len=10)
    assert not dq.any() and not dk.any()
    torch.testing.assert_close(dv[0], (g[0].sum(0) / 40).expand_as(dv[0]), rtol=1e-5, atol=1e-6)


def test_global_attention_fully_masked_rows_average_every_column():
    """A row whose every column is masked softmaxes uniformly (-1e30 fill),
    as in the TPU kernel."""
    q, k, v = (_randn(1, 40, 16, seed=7 + i) for i in range(3))
    out = ak.global_attention_plain(q, k, v, 1, block=16, valid_len=10)
    rows = out[0, 16:]  # blocks starting at 16 hold no column < 10
    torch.testing.assert_close(rows, v[0].mean(0).expand_as(rows), rtol=1e-5, atol=1e-6)


# --- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ with no CPU mode)")
    return torch.device("cuda")


# (dtype, max abs error vs the plain version on O(1) inputs): f32 differs
# only in summation order (fp32 accumulation on both sides; the tensor-core
# kernels' 3xTF32 products keep ~1e-6 relative); bf16 outputs round to 8
# mantissa bits, one ulp near 1 is 2**-7 = 7.8e-3.  In bf16 the tensor-core
# forward of kernels 1, 3, 4 and 15 rounds each tile's unnormalised softmax
# weights (with dropout: kept and scaled, or 0) to bf16 before their product
# with v, and that of kernels 2, 12 and 5 its normalized (and masked)
# weights, as the TPU kernels round theirs, where the plain versions keep
# them in fp32: a relative 2**-9 per weight, well inside one output ulp
# (tests/test_torch_attention_fwd.py and tests/test_torch_local_attention_fwd.py
# emulate it on the CPU); kernel 10 is a RoPE pass, then kernel 1's body.
CARD_CASES = [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CARD_CASES)
@pytest.mark.parametrize("s,block,valid", [(250, 0, 250), (250, 0, 200), (496, 16, 496),
                                           (37, 0, 37)])
def test_global_attention_kernel_matches_plain_on_card(cuda_device, dtype, tol, s, block,
                                                       valid):
    q, k, v = (_randn(16, s, 256, seed=s + valid + i, device=cuda_device, dtype=dtype)
               for i in range(3))
    before = ak.global_attention.launches
    out = ak.global_attention(q, k, v, 4, block, valid)
    ref = ak.global_attention_plain(q, k, v, 4, block, valid)
    torch.cuda.synchronize()
    assert ak.global_attention.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CARD_CASES)
@pytest.mark.parametrize("p_len", [256, 32])
def test_local_two_phase_kernel_matches_plain_on_card(cuda_device, dtype, tol, p_len):
    ts = [_randn(16, p_len, 256, seed=5 + i, device=cuda_device, dtype=dtype)
          for i in range(5)]
    before = ak.local_two_phase.launches
    out = ak.local_two_phase(*ts, 4, 16)
    ref = ak.local_two_phase_plain(*ts, 4, 16)
    torch.cuda.synchronize()
    assert ak.local_two_phase.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take_on_card(cuda_device):
    h = torch.zeros(1, 256, 256, device=cuda_device, dtype=torch.float16)
    with pytest.raises(NotImplementedError):
        ak.global_attention(h, h, h, 4)
    with pytest.raises(NotImplementedError):
        ak.local_two_phase(h, h, h, h, h, 4, 16)
    f = torch.zeros(1, 250, 256, device=cuda_device)
    with pytest.raises(ValueError):  # P must be a multiple of the window
        ak.local_two_phase(f, f, f, f, f, 4, 16)
    with pytest.raises(ValueError):  # head dim 128 is not instantiated
        ak.global_attention(f, f, f, 2)



# The tensor-core forward of kernels 1 and 3 (csrc/global_attention_fwd.cu)
# at the geometries it must take: head dims 16, 32, 64; S from one row to
# 496, ragged against the 64-row tile; valid_len; block 16 (whose key tiles
# outside a query tile's blocks are skipped).
FWD_GEOMETRIES = [(1, 0, 1), (37, 0, 37), (64, 0, 64), (65, 0, 65), (250, 0, 250),
                  (250, 0, 200), (496, 16, 496)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CARD_CASES)
@pytest.mark.parametrize("hd,heads", [(64, 4), (32, 4), (16, 2)])
@pytest.mark.parametrize("s,block,valid", FWD_GEOMETRIES)
def test_global_attention_forward_geometries_on_card(cuda_device, dtype, tol, hd, heads, s,
                                                     block, valid):
    q, k, v = (_randn(8, s, heads * hd, seed=s + valid + hd + i, device=cuda_device, dtype=dtype)
               for i in range(3))
    before = ak.global_attention.launches
    out = ak.global_attention(q, k, v, heads, block, valid)
    ref = ak.global_attention_plain(q, k, v, heads, block, valid)
    torch.cuda.synchronize()
    assert ak.global_attention.launches == before + 1
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CARD_CASES)
@pytest.mark.parametrize("hd,heads", [(64, 4), (32, 4), (16, 2)])
@pytest.mark.parametrize("s,block", [(s, block) for s, block, valid in FWD_GEOMETRIES
                                     if valid == s])
def test_head_major_attention_geometries_on_card(cuda_device, dtype, tol, hd, heads, s, block):
    q, k, v = (_randn(8, heads, s, hd, seed=s + hd + i, device=cuda_device, dtype=dtype)
               for i in range(3))
    before = ak.head_major_attention.launches
    out = ak.head_major_attention(q, k, v, block)
    ref = ak.head_major_attention_plain(q, k, v, block)
    torch.cuda.synchronize()
    assert ak.head_major_attention.launches == before + 1
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CARD_CASES)
def test_global_attention_forward_at_the_serving_batch_on_card(cuda_device, dtype, tol):
    """128 windows of S = 250, 4 heads x 64: the serving batch; kernel 3 on
    the head-major copies of the same tensors."""
    q, k, v = (_randn(128, 250, 256, seed=128 + i, device=cuda_device, dtype=dtype)
               for i in range(3))
    out = ak.global_attention(q, k, v, 4)
    ref = ak.global_attention_plain(q, k, v, 4)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    heads = lambda t: t.reshape(128, 250, 4, 64).transpose(1, 2).contiguous()
    out3 = ak.head_major_attention(heads(q), heads(k), heads(v))
    assert torch.equal(out3, heads(out))  # the same body on the same rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CARD_CASES)
def test_global_attention_forward_fully_masked_rows_on_card(cuda_device, dtype, tol):
    """S = 80, block 16, valid_len 40: the rows of the blocks at 48 and 64
    see no column and average all S columns, as on the TPU."""
    q, k, v = (_randn(4, 80, 256, seed=80 + i, device=cuda_device, dtype=dtype)
               for i in range(3))
    out = ak.global_attention(q, k, v, 4, 16, 40)
    ref = ak.global_attention_plain(q, k, v, 4, 16, 40)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    rows = out[:, 48:].float()
    mean = v.float().mean(1, keepdim=True).expand_as(rows)
    assert (rows - mean).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["global", "head major"])
def test_global_attention_forward_repeats_bit_for_bit_on_card(cuda_device, dtype, kernel):
    if kernel == "global":
        q, k, v = (_randn(32, 250, 256, seed=3 + i, device=cuda_device, dtype=dtype)
                   for i in range(3))
        call = lambda: ak.global_attention(q, k, v, 4, 0, 200)
    else:
        q, k, v = (_randn(16, 4, 496, 64, seed=3 + i, device=cuda_device, dtype=dtype)
                   for i in range(3))
        call = lambda: ak.head_major_attention(q, k, v, 16)
    assert torch.equal(call(), call())


@pytest.mark.cuda
def test_head_major_attention_refuses_past_the_grid_on_card(cuda_device):
    """G*H samples lie on the grid's z dimension: at most 65,535."""
    t = torch.zeros(16383, 4, 1, 16, device=cuda_device)
    assert ak.head_major_attention(t, t, t).shape == t.shape   # 65,532 samples
    over = torch.zeros(16384, 4, 1, 16, device=cuda_device)    # 65,536
    before = ak.head_major_attention.launches
    with pytest.raises(ValueError):
        ak.head_major_attention(over, over, over)
    assert ak.head_major_attention.launches == before


@pytest.mark.cuda
def test_global_attention_forward_refuses_misaligned_buffers_on_card(cuda_device):
    """The tiles are copied 16 bytes at a time: a buffer that does not start
    on 16 bytes is refused, nothing launched."""
    buf = torch.zeros(1 + 64 * 64, device=cuda_device)
    q = buf[1:].view(1, 64, 64)
    assert q.is_contiguous()
    before = ak.global_attention.launches
    with pytest.raises(RuntimeError, match="misaligned"):
        ak.global_attention(q, q, q, 1)
    assert ak.global_attention.launches == before

# The backward kernels.  f32: the kernel and the plain version compute the
# same fp32 sums in another order (and the kernel's softmax is online), so
# they agree to a few fp32 ulps of the largest term -- 2e-5 of the output's
# largest magnitude.  bf16: outputs round to 8 mantissa bits and an fp32
# difference of one ulp can flip the bf16 rounding of a weight or a dlogit
# before the products.  One such flip reads exactly one bf16 ulp of the
# output's top binade, so the limit is 3 of those ulps: a reading of one or
# two ulps never sits on it.
GRAD_CASES = [(torch.float32, 2e-5), (torch.bfloat16, 3)]


def _assert_grads_close(outs, refs, tol):
    """``tol``: for f32 outputs a share of the largest magnitude (at least
    of 1), for bf16 outputs a number of ulps of the largest magnitude's binade."""
    for i, (out, ref) in enumerate(zip(outs, refs)):
        assert out.shape == ref.shape and out.dtype == ref.dtype
        assert torch.isfinite(out.float()).all()
        top = ref.float().abs().max().item()
        if ref.dtype == torch.bfloat16:
            allowed = tol * 2.0 ** (math.ceil(math.log2(max(top, 2.0 ** -100))) - 8)
        else:
            allowed = tol * max(1.0, top)
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= allowed, f"output {i}: err {err:.3e} > {allowed:.3e} (largest {top:.3f})"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", GRAD_CASES)
@pytest.mark.parametrize("s,block,valid,with_bits", [
    (250, 0, 250, False), (250, 0, 200, False), (496, 16, 496, False), (37, 0, 37, False),
    (80, 16, 40, False),  # rows whose whole block lies past valid_len
    (250, 0, 250, True), (96, 16, 96, True),
    # the 64-row tile's edges: one row, one short of a tile, one and two past
    (1, 0, 1, False), (63, 0, 63, False), (65, 0, 65, False), (129, 0, 129, False),
    (65, 0, 65, True),
])
def test_global_attention_grads_kernel_matches_plain_on_card(cuda_device, dtype, tol, s, block,
                                                             valid, with_bits):
    n = 32 if s == 250 else 8
    q, k, v, g = (_randn(n, s, 256, seed=s + valid + i, device=cuda_device, dtype=dtype)
                  for i in range(4))
    bits, threshold = None, 0
    if with_bits:
        gen = torch.Generator(device="cpu").manual_seed(s)
        bits = torch.randint(0, 256, (n, 4, s, s), generator=gen, dtype=torch.uint8).to(
            cuda_device)
        threshold = 26
    before = ak.global_attention_grads.launches
    outs = ak.global_attention_grads(q, k, v, g, 4, block, valid, bits, threshold)
    refs = ak.global_attention_grads_plain(q, k, v, g, 4, block, valid, bits, threshold)
    torch.cuda.synchronize()
    assert ak.global_attention_grads.launches == before + 1
    _assert_grads_close(outs, refs, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", GRAD_CASES)
# 48, 80 and 272: a block's 64 rows cut short by P
@pytest.mark.parametrize("p_len", [256, 32, 16, 48, 80, 272])
def test_local_two_phase_grads_kernel_matches_plain_on_card(cuda_device, dtype, tol, p_len):
    ts = [_randn(32, p_len, 256, seed=15 + i, device=cuda_device, dtype=dtype)
          for i in range(6)]
    before = ak.local_two_phase_grads.launches
    outs = ak.local_two_phase_grads(*ts, 4, 16)
    refs = ak.local_two_phase_grads_plain(*ts, 4, 16)
    torch.cuda.synchronize()
    assert ak.local_two_phase_grads.launches == before + 1
    _assert_grads_close(outs, refs, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,heads", [(16, 2), (32, 2)])
def test_grads_kernels_other_head_dims_on_card(cuda_device, hd, heads):
    ts = [_randn(4, 64, heads * hd, seed=25 + i, device=cuda_device) for i in range(6)]
    _assert_grads_close(ak.local_two_phase_grads(*ts, heads, 16),
                        ak.local_two_phase_grads_plain(*ts, heads, 16), 2e-5)
    q, k, v, g = ts[:4]
    _assert_grads_close(ak.global_attention_grads(q, k, v, g, heads, 0, 50),
                        ak.global_attention_grads_plain(q, k, v, g, heads, 0, 50), 2e-5)


@pytest.mark.cuda
def test_wrappers_are_differentiable_through_the_kernels_on_card(cuda_device):
    """The outputs carry a grad_fn and backward launches the backward
    kernels, also for a cotangent that is not dense."""
    q, k, v = (_randn(4, 250, 256, seed=31 + i, device=cuda_device).requires_grad_()
               for i in range(3))
    before = [fn.launches for fn in ak.KERNELS]
    out = ak.global_attention(q, k, v, 4)
    assert out.grad_fn is not None
    cot = _randn(4, 250, 512, seed=40, device=cuda_device)[:, :, ::2]
    grads = torch.autograd.grad(out, (q, k, v), cot)
    refs = ak.global_attention_grads_plain(q.detach(), k.detach(), v.detach(),
                                           cot.contiguous(), 4)
    _assert_grads_close(grads, refs, 2e-5)

    ts = [_randn(4, 256, 256, seed=50 + i, device=cuda_device).requires_grad_()
          for i in range(5)]
    out = ak.local_two_phase(*ts, 4, 16)
    assert out.grad_fn is not None
    loss = out[:, :250].square().sum()   # the crop makes the cotangent a padded view
    grads = torch.autograd.grad(loss, ts)
    cot = torch.zeros_like(out)
    cot[:, :250] = 2 * out.detach()[:, :250]
    refs = ak.local_two_phase_grads_plain(*(t.detach() for t in ts), cot, 4, 16)
    _assert_grads_close(grads, refs, 2e-5)
    torch.cuda.synchronize()
    # One launch of each of the four dropout-free kernels, none of the others.
    assert [fn.launches for fn in ak.KERNELS] == [n + 1 for n in before[:4]] + before[4:]


@pytest.mark.cuda
def test_grads_kernels_refuse_what_they_do_not_take_on_card(cuda_device):
    h = torch.zeros(1, 256, 256, device=cuda_device, dtype=torch.float16)
    with pytest.raises(NotImplementedError):
        ak.global_attention_grads(h, h, h, h, 4)
    with pytest.raises(NotImplementedError):
        ak.local_two_phase_grads(h, h, h, h, h, h, 4, 16)
    f = torch.zeros(1, 250, 256, device=cuda_device)
    with pytest.raises(ValueError):  # P must be a multiple of the window
        ak.local_two_phase_grads(f, f, f, f, f, f, 4, 16)
    bits = torch.zeros(1, 4, 250, 250, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):  # a threshold that keeps all or nothing
        ak.global_attention_grads(f, f, f, f, 4, bits=bits, threshold=0)
    with pytest.raises(ValueError):  # bits of another shape
        ak.global_attention_grads(f, f, f, f, 4, bits=bits[:, :, :128], threshold=26)
    # A contiguous view that starts one element into its storage: the tiles
    # are copied 16 bytes at a time, so the C entry refuses it and launches
    # nothing.
    before = ak.global_attention_grads.launches
    shifted = torch.zeros(250 * 256 + 1, device=cuda_device)[1:].view(1, 250, 256)
    with pytest.raises(RuntimeError, match="misaligned"):
        ak.global_attention_grads(shifted, f, f, f, 4)
    assert ak.global_attention_grads.launches == before


# --- the dropout kernels on the card ---------------------------------------

THRESHOLD = 26  # round(0.1 * 256)


def _seed(a: int, b: int, device="cpu") -> torch.Tensor:
    return torch.tensor([a, b], dtype=torch.int32, device=device)


def _random_bits(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("samples,cores,p_len", [(32, 4, 250), (32, 8, 256), (3, 2, 37),
                                                 (2, 8, 16), (1, 1, 496),
                                                 (1, 1, 1), (2, 3, 1), (3, 1, 15), (2, 2, 15),
                                                 (1, 3, 17), (4, 2, 17), (5, 3, 37),
                                                 (3, 7, 250), (33, 1, 255)])
def test_philox_dump_kernel_equals_plain_philox_on_card(cuda_device, samples, cores, p_len):
    """Kernel 14: the bytes of the kernel are those of the plain Philox, on
    the card and on the CPU.  P of 1, 15 and 17 (a line shorter than a
    Philox group, or one byte past it) and outputs whose size is not a
    multiple of 16 bytes (samples x cores x P^2 odd) end inside a 16-byte
    store of the kernel."""
    seed = _seed(1234567, -89, cuda_device)
    before = ak.philox_bits.launches
    out = ak.philox_bits(seed, samples, cores, p_len)
    torch.cuda.synchronize()
    assert ak.philox_bits.launches == before + 1
    assert out.dtype == torch.uint8 and tuple(out.shape) == (samples, cores, p_len, p_len)
    assert torch.equal(out, ak.philox_bits_plain(seed, samples, cores, p_len))
    assert torch.equal(out.cpu(), ak.philox_bits_plain(seed.cpu(), samples, cores, p_len))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CARD_CASES)
@pytest.mark.parametrize("source", ["philox", "bits"])
@pytest.mark.parametrize("s,block,valid", [(250, 0, 250), (250, 0, 200), (496, 16, 496),
                                           (37, 0, 37), (80, 16, 40)])
def test_global_attention_dropout_kernels_match_plain_on_card(cuda_device, dtype, tol, source,
                                                              s, block, valid):
    """Kernels 15 and 4 against the plain bits version: the seeded kernel on
    the bytes kernel 14 dumps for its seed, the bits kernel on random bytes."""
    n = 32 if s == 250 else 8
    q, k, v = (_randn(n, s, 256, seed=s + valid + i, device=cuda_device, dtype=dtype)
               for i in range(3))
    if source == "philox":
        seed = _seed(s, valid, cuda_device)
        bits = ak.philox_bits(seed, n, 4, s)
        wrapper = ak.global_attention_dropout
        out = wrapper(q, k, v, seed, 4, block, valid, threshold=THRESHOLD)
    else:
        bits = _random_bits((n, 4, s, s), s, cuda_device)
        wrapper = ak.global_attention_dropout_bits
        out = wrapper(q, k, v, bits, 4, block, valid, threshold=THRESHOLD)
    before = wrapper.launches
    ref = ak.global_attention_plain(q, k, v, 4, block, valid, bits, THRESHOLD)
    torch.cuda.synchronize()
    assert wrapper.launches == before  # the plain version launches no kernel
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    plain_free = ak.global_attention_plain(q, k, v, 4, block, valid)
    assert (out.float() - plain_free.float()).abs().max().item() > 10 * tol  # it did drop


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,block,valid", [(250, 0, 250), (250, 0, 200), (496, 16, 496),
                                           (37, 0, 37), (80, 16, 40)])
def test_global_attention_dropout_seeded_equals_bits_kernel_on_dumped_bytes_on_card(
        cuda_device, dtype, s, block, valid):
    """Kernels 15 and 4 are one body with two mask sources: on the bytes
    kernel 14 dumps for the seed, the bits kernel gives the seeded kernel's
    output bit for bit."""
    n = 32 if s == 250 else 8
    q, k, v = (_randn(n, s, 256, seed=3 * s + valid + i, device=cuda_device, dtype=dtype)
               for i in range(3))
    seed = _seed(valid, -s, cuda_device)
    seeded = ak.global_attention_dropout(q, k, v, seed, 4, block, valid, threshold=THRESHOLD)
    bits = ak.global_attention_dropout_bits(q, k, v, ak.philox_bits(seed, n, 4, s), 4, block,
                                            valid, threshold=THRESHOLD)
    torch.cuda.synchronize()
    assert torch.equal(seeded, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [250, 37])
def test_global_attention_dropout_bits_kernel_takes_bits_at_any_alignment_on_card(
        cuda_device, dtype, s):
    """Kernel 4 copies its bits by the aligned word, at each row's skew:
    the same bytes starting 1, 2 or 3 bytes past a word give the same
    output bits as an aligned copy."""
    q, k, v = (_randn(8, s, 256, seed=s + 7 + i, device=cuda_device, dtype=dtype)
               for i in range(3))
    bits = _random_bits((8, 4, s, s), s, cuda_device)
    aligned = ak.global_attention_dropout_bits(q, k, v, bits, 4, threshold=THRESHOLD)
    for offset in (1, 2, 3):
        storage = torch.zeros(bits.numel() + offset, dtype=torch.uint8, device=cuda_device)
        shifted = storage[offset:].view(bits.shape)
        shifted.copy_(bits)
        out = ak.global_attention_dropout_bits(q, k, v, shifted, 4, threshold=THRESHOLD)
        torch.cuda.synchronize()
        assert torch.equal(out, aligned), offset


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("source", ["bits", "philox"])
def test_global_attention_dropout_kernels_repeat_bit_for_bit_on_card(cuda_device, dtype,
                                                                      source):
    """Kernels 4 and 15 give the same output bits for the same inputs: no
    atomics, every sum in a fixed order."""
    q, k, v = (_randn(32, 250, 256, seed=95 + i, device=cuda_device, dtype=dtype)
               for i in range(3))
    if source == "philox":
        seed = _seed(95, 96, cuda_device)
        call = lambda: ak.global_attention_dropout(q, k, v, seed, 4, threshold=THRESHOLD)
    else:
        bits = _random_bits((32, 4, 250, 250), 97, cuda_device)
        call = lambda: ak.global_attention_dropout_bits(q, k, v, bits, 4, threshold=THRESHOLD)
    first, again = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", GRAD_CASES)
@pytest.mark.parametrize("s,block,valid", [(250, 0, 250), (250, 0, 200), (496, 16, 496),
                                           (37, 0, 37), (80, 16, 40),
                                           (1, 0, 1), (63, 0, 63), (65, 0, 65), (129, 0, 129)])
def test_global_attention_grads_prng_kernel_matches_plain_on_card(cuda_device, dtype, tol, s,
                                                                  block, valid):
    """Kernel 16 against the plain backward on the bytes kernel 14 dumps."""
    n = 32 if s == 250 else 8
    q, k, v, g = (_randn(n, s, 256, seed=s + valid + i, device=cuda_device, dtype=dtype)
                  for i in range(4))
    seed = _seed(-s, valid, cuda_device)
    before = ak.global_attention_grads_prng.launches
    outs = ak.global_attention_grads_prng(q, k, v, seed, g, 4, block, valid, threshold=THRESHOLD)
    refs = ak.global_attention_grads_plain(q, k, v, g, 4, block, valid,
                                           ak.philox_bits(seed, n, 4, s), THRESHOLD)
    torch.cuda.synchronize()
    assert ak.global_attention_grads_prng.launches == before + 1
    _assert_grads_close(outs, refs, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("source", ["none", "bits", "philox"])
def test_global_attention_grads_kernels_repeat_bit_for_bit_on_card(cuda_device, dtype, source):
    """Kernels 9 (no mask, bits) and 16 give the same output bits for the
    same inputs: no atomics, every sum in a fixed order."""
    q, k, v, g = (_randn(32, 250, 256, seed=90 + i, device=cuda_device, dtype=dtype)
                  for i in range(4))
    if source == "philox":
        seed = _seed(90, 91, cuda_device)
        call = lambda: ak.global_attention_grads_prng(q, k, v, seed, g, 4, threshold=THRESHOLD)
    else:
        bits = _random_bits((32, 4, 250, 250), 92, cuda_device) if source == "bits" else None
        call = lambda: ak.global_attention_grads(q, k, v, g, 4, 0, None, bits,
                                                 THRESHOLD if source == "bits" else 0)
    first, again = call(), call()
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CARD_CASES)
@pytest.mark.parametrize("source", ["philox", "bits"])
@pytest.mark.parametrize("p_len", [256, 32, 16])
def test_local_two_phase_dropout_kernels_match_plain_on_card(cuda_device, dtype, tol, source,
                                                             p_len):
    """Kernels 12 and 5 against the plain bits version."""
    ts = [_randn(32, p_len, 256, seed=5 + i, device=cuda_device, dtype=dtype)
          for i in range(5)]
    if source == "philox":
        seed = _seed(p_len, 77, cuda_device)
        bits_a, bits_b = ak.two_phase_planes(ak.philox_bits(seed, 32, 8, p_len), 4)
        out = ak.local_two_phase_dropout(*ts, seed, 4, 16, threshold=THRESHOLD)
    else:
        bits_a, bits_b = (_random_bits((32, 4, p_len, p_len), p_len + i, cuda_device)
                          for i in range(2))
        out = ak.local_two_phase_dropout_bits(*ts, bits_a, bits_b, 4, 16, threshold=THRESHOLD)
    ref = ak.local_two_phase_plain(*ts, 4, 16, bits_a, bits_b, THRESHOLD)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    plain_free = ak.local_two_phase_plain(*ts, 4, 16)
    assert (out.float() - plain_free.float()).abs().max().item() > 10 * tol  # it did drop


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", GRAD_CASES)
@pytest.mark.parametrize("source", ["philox", "bits"])
@pytest.mark.parametrize("p_len", [256, 32, 16, 48, 80, 272])
def test_local_two_phase_dropout_grads_kernels_match_plain_on_card(cuda_device, dtype, tol,
                                                                   source, p_len):
    """Kernels 13 and 8 against the plain backward."""
    ts = [_randn(32, p_len, 256, seed=15 + i, device=cuda_device, dtype=dtype)
          for i in range(6)]
    if source == "philox":
        seed = _seed(-p_len, 3, cuda_device)
        bits_a, bits_b = ak.two_phase_planes(ak.philox_bits(seed, 32, 8, p_len), 4)
        wrapper = ak.local_two_phase_grads_prng
        before = wrapper.launches
        outs = wrapper(*ts[:5], seed, ts[5], 4, 16, threshold=THRESHOLD)
    else:
        bits_a, bits_b = (_random_bits((32, 4, p_len, p_len), p_len + i, cuda_device)
                          for i in range(2))
        wrapper = ak.local_two_phase_grads_bits
        before = wrapper.launches
        outs = wrapper(*ts[:5], bits_a, bits_b, ts[5], 4, 16, threshold=THRESHOLD)
    refs = ak.local_two_phase_grads_plain(*ts, 4, 16, bits_a, bits_b, THRESHOLD)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _assert_grads_close(outs, refs, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("source", ["none", "philox", "bits"])
def test_local_two_phase_grads_kernels_repeat_bit_for_bit_on_card(cuda_device, dtype, source):
    """Kernels 7, 13 and 8: no atomics and sums in a fixed order, so the same
    inputs give the same bits."""
    ts = [_randn(32, 256, 256, seed=35 + i, device=cuda_device, dtype=dtype) for i in range(6)]
    if source == "philox":
        seed = _seed(11, 12, cuda_device)
        call = lambda: ak.local_two_phase_grads_prng(*ts[:5], seed, ts[5], 4, 16,
                                                    threshold=THRESHOLD)
    elif source == "bits":
        bits_a, bits_b = (_random_bits((32, 4, 256, 256), 60 + i, cuda_device) for i in range(2))
        call = lambda: ak.local_two_phase_grads_bits(*ts[:5], bits_a, bits_b, ts[5], 4, 16,
                                                    threshold=THRESHOLD)
    else:
        call = lambda: ak.local_two_phase_grads(*ts, 4, 16)
    first, again = call(), call()
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 5, "bits"])
def test_local_two_phase_grads_refuses_misaligned_buffers_on_card(cuda_device, which):
    """The rows are copied 16 bytes at a time (and the bits 8): an input that
    does not start on 16 bytes is refused by the C entry, nothing launched."""
    ts = [torch.zeros(2, 64, 64, device=cuda_device) for _ in range(6)]
    bits = [torch.zeros(2, 4, 64, 64, dtype=torch.uint8, device=cuda_device) for _ in range(2)]
    if which == "bits":
        bits[1] = torch.zeros(1 + bits[1].numel(), dtype=torch.uint8,
                              device=cuda_device)[1:].view(2, 4, 64, 64)
        wrapper = ak.local_two_phase_grads_bits
        call = lambda: wrapper(*ts[:5], *bits, ts[5], 4, 16, threshold=THRESHOLD)
    else:
        ts[which] = torch.zeros(1 + ts[which].numel(), device=cuda_device)[1:].view(2, 64, 64)
        wrapper = ak.local_two_phase_grads
        call = lambda: wrapper(*ts, 4, 16)
    assert all(t.is_contiguous() for t in ts + bits)
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="misaligned"):
        call()
    assert wrapper.launches == before


# The tensor-core forward of kernels 2, 12 and 5 (csrc/local_attention_fwd.cuh)
# at the geometries it must take: P from one 64-row block short (32, 48) to
# past a multiple of it (80, 272), one sample to the serving batch, head dims
# 16, 32, 64.  Beside the plain version (CARD_CASES: in bf16 it keeps fp32
# weights where the kernel rounds them, as the TPU kernel does) it is held to
# the emulation of its own order of operations,
# tests/test_torch_local_attention_fwd.tensor_core_local_forward, run on the
# card: f32 within 2e-6 (3xTF32 products against fp32 ones, ~1e-6 relative),
# bf16 within one ulp of the output's top binade (an fp32 sum in another
# order flips a rounding by one ulp).
LOCAL_FWD_TO_EMULATION = {torch.float32: 2e-6, torch.bfloat16: 1}


def _local_forward_call(source: str, ts, heads: int, device, seed_words: tuple[int, int]):
    """(wrapper, call, bits_a, bits_b, threshold) of one mask source; the
    seeded source's bits are the dump kernel's bytes of its seed."""
    b, p_len = ts[0].shape[:2]
    if source == "philox":
        seed = _seed(*seed_words, device)
        bits = ak.two_phase_planes(ak.philox_bits(seed, b, 2 * heads, p_len), heads)
        wrapper = ak.local_two_phase_dropout
        call = lambda: wrapper(*ts, seed, heads, 16, threshold=THRESHOLD)
        return wrapper, call, *bits, THRESHOLD
    if source == "bits":
        bits = [_random_bits((b, heads, p_len, p_len), sum(seed_words) + i, device)
                for i in range(2)]
        wrapper = ak.local_two_phase_dropout_bits
        call = lambda: wrapper(*ts, *bits, heads, 16, threshold=THRESHOLD)
        return wrapper, call, *bits, THRESHOLD
    return ak.local_two_phase, lambda: ak.local_two_phase(*ts, heads, 16), None, None, 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CARD_CASES)
@pytest.mark.parametrize("source", ["none", "philox", "bits"])
@pytest.mark.parametrize("hd", [64, 32, 16])
@pytest.mark.parametrize("batch", [1, 16, 128])
@pytest.mark.parametrize("p_len", [32, 48, 80, 256, 272])
def test_local_two_phase_forward_kernels_match_plain_on_card(cuda_device, dtype, tol, source,
                                                             hd, batch, p_len):
    """Kernels 2, 12 and 5 against their plain version and against the
    emulation of the tensor-core body's arithmetic."""
    # By the name pytest imports the test files under: a package named
    # ``tests`` may be installed on the card's machine.
    from test_torch_local_attention_fwd import tensor_core_local_forward

    heads = 4 if hd > 16 else 2
    ts = [_randn(batch, p_len, heads * hd, seed=p_len + hd + batch + i, device=cuda_device,
                 dtype=dtype) for i in range(5)]
    wrapper, call, bits_a, bits_b, threshold = _local_forward_call(source, ts, heads, cuda_device,
                                                                   (p_len, batch))
    before = wrapper.launches
    out = call()
    ref = ak.local_two_phase_plain(*ts, heads, 16, bits_a, bits_b, threshold)
    emulated = tensor_core_local_forward(*ts, heads, bits_a, bits_b, threshold)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert out.shape == ref.shape and out.dtype == dtype and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    err = (out.float() - emulated.float()).abs().max().item()
    if dtype == torch.bfloat16:
        top = emulated.float().abs().max().item()
        err /= 2.0 ** (math.ceil(math.log2(max(top, 2.0 ** -100))) - 8)  # in ulps
    assert err <= LOCAL_FWD_TO_EMULATION[dtype]
    if source != "none":
        plain_free = ak.local_two_phase_plain(*ts, heads, 16)
        assert (out.float() - plain_free.float()).abs().max().item() > 10 * tol  # it did drop


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("source", ["none", "philox", "bits"])
def test_local_two_phase_forward_kernels_repeat_bit_for_bit_on_card(cuda_device, dtype, source):
    """Kernels 2, 12 and 5: no atomics and sums in a fixed order, so the same
    inputs give the same bits."""
    ts = [_randn(32, 256, 256, seed=45 + i, device=cuda_device, dtype=dtype) for i in range(5)]
    _, call, *_ = _local_forward_call(source, ts, 4, cuda_device, (21, 22))
    first, again = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 4, "bits"])
def test_local_two_phase_refuses_misaligned_buffers_on_card(cuda_device, which):
    """The rows are copied and the output stored 16 bytes at a time (the bits
    copied 8): an input that does not start on 16 bytes is refused by the C
    entry, nothing launched."""
    ts = [torch.zeros(2, 64, 64, device=cuda_device) for _ in range(5)]
    bits = [torch.zeros(2, 4, 64, 64, dtype=torch.uint8, device=cuda_device) for _ in range(2)]
    if which == "bits":
        bits[0] = torch.zeros(1 + bits[0].numel(), dtype=torch.uint8,
                              device=cuda_device)[1:].view(2, 4, 64, 64)
        wrapper = ak.local_two_phase_dropout_bits
        call = lambda: wrapper(*ts, *bits, 4, 16, threshold=THRESHOLD)
    else:
        ts[which] = torch.zeros(1 + ts[which].numel(), device=cuda_device)[1:].view(2, 64, 64)
        wrapper = ak.local_two_phase
        call = lambda: wrapper(*ts, 4, 16)
    assert all(t.is_contiguous() for t in ts + bits)
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="misaligned"):
        call()
    assert wrapper.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("hd,heads", [(16, 2), (32, 2)])
def test_dropout_kernels_other_head_dims_on_card(cuda_device, hd, heads):
    ts = [_randn(4, 64, heads * hd, seed=25 + i, device=cuda_device) for i in range(6)]
    seed = _seed(hd, heads, cuda_device)
    bits_a, bits_b = ak.two_phase_planes(ak.philox_bits(seed, 4, 2 * heads, 64), heads)
    out = ak.local_two_phase_dropout(*ts[:5], seed, heads, 16, threshold=THRESHOLD)
    ref = ak.local_two_phase_plain(*ts[:5], heads, 16, bits_a, bits_b, THRESHOLD)
    assert (out - ref).abs().max().item() <= 1e-5
    _assert_grads_close(
        ak.local_two_phase_grads_prng(*ts[:5], seed, ts[5], heads, 16, threshold=THRESHOLD),
        ak.local_two_phase_grads_plain(*ts, heads, 16, bits_a, bits_b, THRESHOLD), 2e-5)
    q, k, v, g = ts[:4]
    bits = ak.philox_bits(seed, 4, heads, 64)
    out = ak.global_attention_dropout(q, k, v, seed, heads, 0, 50, threshold=THRESHOLD)
    ref = ak.global_attention_plain(q, k, v, heads, 0, 50, bits, THRESHOLD)
    assert (out - ref).abs().max().item() <= 1e-5
    _assert_grads_close(
        ak.global_attention_grads_prng(q, k, v, seed, g, heads, 0, 50, threshold=THRESHOLD),
        ak.global_attention_grads_plain(q, k, v, g, heads, 0, 50, bits, THRESHOLD), 2e-5)


@pytest.mark.cuda
def test_seeded_dropout_is_reproducible_and_keeps_at_its_rate_on_card(cuda_device):
    """The same seed twice gives the same bits of output, another seed
    another mask, and the dumped bytes keep 230 in 256 within 4 sigma."""
    q, k, v = (_randn(8, 250, 256, seed=60 + i, device=cuda_device, dtype=torch.bfloat16)
               for i in range(3))
    s1, s2 = _seed(1, 2, cuda_device), _seed(1, 3, cuda_device)
    a = ak.global_attention_dropout(q, k, v, s1, 4, threshold=THRESHOLD)
    b = ak.global_attention_dropout(q, k, v, s1.clone(), 4, threshold=THRESHOLD)
    c = ak.global_attention_dropout(q, k, v, s2, 4, threshold=THRESHOLD)
    assert torch.equal(a, b) and not torch.equal(a, c)
    ts = [_randn(8, 256, 256, seed=70 + i, device=cuda_device, dtype=torch.bfloat16)
          for i in range(5)]
    a = ak.local_two_phase_dropout(*ts, s1, 4, 16, threshold=THRESHOLD)
    b = ak.local_two_phase_dropout(*ts, s1.clone(), 4, 16, threshold=THRESHOLD)
    c = ak.local_two_phase_dropout(*ts, s2, 4, 16, threshold=THRESHOLD)
    assert torch.equal(a, b) and not torch.equal(a, c)
    bits = ak.philox_bits(s1, 32, 8, 256)
    keep, n = (bits >= THRESHOLD).float().mean().item(), bits.numel()
    p = (256 - THRESHOLD) / 256
    assert abs(keep - p) <= 4 * math.sqrt(p * (1 - p) / n)


@pytest.mark.cuda
def test_dropout_wrappers_are_differentiable_through_the_kernels_on_card(cuda_device):
    """Forward and backward of the seeded wrappers use the same mask: the
    gradients equal the plain backward on the dumped bytes, and only the
    seeded kernels are launched."""
    seed = _seed(9, 10, cuda_device)
    q, k, v = (_randn(4, 250, 256, seed=31 + i, device=cuda_device).requires_grad_()
               for i in range(3))
    before = [fn.launches for fn in ak.KERNELS]
    out = ak.global_attention_dropout(q, k, v, seed, 4, threshold=THRESHOLD)
    cot = _randn(4, 250, 512, seed=40, device=cuda_device)[:, :, ::2]
    grads = torch.autograd.grad(out, (q, k, v), cot)
    ts = [_randn(4, 256, 256, seed=50 + i, device=cuda_device).requires_grad_()
          for i in range(5)]
    out_l = ak.local_two_phase_dropout(*ts, seed, 4, 16, threshold=THRESHOLD)
    grads_l = torch.autograd.grad(out_l[:, :250].square().sum(), ts)
    torch.cuda.synchronize()
    launched = [fn.launches - n for fn, n in zip(ak.KERNELS, before)]
    assert launched == [0, 0, 0, 0, 1, 1, 1, 1] + [0] * (len(ak.KERNELS) - 8)

    refs = ak.global_attention_grads_plain(q.detach(), k.detach(), v.detach(), cot.contiguous(),
                                           4, 0, None, ak.philox_bits(seed, 4, 4, 250), THRESHOLD)
    _assert_grads_close(grads, refs, 2e-5)
    cot_l = torch.zeros_like(out_l)
    cot_l[:, :250] = 2 * out_l.detach()[:, :250]
    bits_a, bits_b = ak.two_phase_planes(ak.philox_bits(seed, 4, 8, 256), 4)
    refs_l = ak.local_two_phase_grads_plain(*(t.detach() for t in ts), cot_l, 4, 16,
                                            bits_a, bits_b, THRESHOLD)
    _assert_grads_close(grads_l, refs_l, 2e-5)


@pytest.mark.cuda
def test_dropout_kernels_refuse_what_they_do_not_take_on_card(cuda_device):
    f = torch.zeros(1, 256, 256, device=cuda_device)
    seed = _seed(1, 2, cuda_device)
    with pytest.raises(ValueError):  # a threshold that keeps all or nothing
        ak.global_attention_dropout(f, f, f, seed, 4, threshold=256)
    with pytest.raises(ValueError):  # the seed must lie on the inputs' device
        ak.global_attention_dropout(f, f, f, seed.cpu(), 4, threshold=THRESHOLD)
    with pytest.raises(ValueError):  # (2,) int32
        ak.local_two_phase_dropout(f, f, f, f, f, seed.long(), 4, 16, threshold=THRESHOLD)
    bits = torch.zeros(1, 4, 256, 256, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):  # bits of another shape
        ak.local_two_phase_dropout_bits(f, f, f, f, f, bits, bits[:, :2], 4, 16,
                                        threshold=THRESHOLD)
    with pytest.raises(ValueError):
        ak.global_attention_dropout_bits(f, f, f, bits[:, :, :128], 4, threshold=THRESHOLD)
    h = f.half()
    with pytest.raises(NotImplementedError):
        ak.global_attention_dropout(h, h, h, seed, 4, threshold=THRESHOLD)


# --- kernels 6, 3 and 10: the attention-core variants -------------------------
#
# Tolerances as CARD_CASES: the kernels and their plain versions take the
# same fp32 sums in another order (kernel 6 casts its softmax weights to the
# dtype before the product with v, and so does its plain version).


def _rope_tables(rows: int, hd: int, device):
    pos = torch.arange(rows, dtype=torch.float32)[:, None] * 0.1 * (
        torch.arange(hd // 2, dtype=torch.float32)[None, :] + 1)
    return torch.cos(pos).to(device), torch.sin(pos).to(device)


def _variant_case(kernel: str, dtype, hd: int, heads: int, device, p_len=256, block=0, seed=0):
    """(the wrapper's output, the plain version's) of one kernel on seeded
    inputs at 16 windows."""
    n = 16
    if kernel == "rw":
        ts = [_randn(n, p_len, heads * hd, seed=seed + i, device=device, dtype=dtype)
              for i in range(5)]
        return ak.local_two_phase_rw(*ts, heads, 16), ak.local_two_phase_rw_plain(*ts, heads, 16)
    if kernel == "head major":
        q, k, v = (_randn(n, heads, p_len, hd, seed=seed + i, device=device, dtype=dtype)
                   for i in range(3))
        return (ak.head_major_attention(q, k, v, block),
                ak.head_major_attention_plain(q, k, v, block))
    q, k, v = (_randn(n, p_len, heads * hd, seed=seed + i, device=device, dtype=dtype)
               for i in range(3))
    cos, sin = _rope_tables(p_len + 8, hd, device)
    return (ak.rope_attention(q, k, v, cos, sin, heads, block),
            ak.rope_attention_plain(q, k, v, cos, sin, heads, block))


VARIANT_WRAPPERS = {"rw": ak.local_two_phase_rw, "head major": ak.head_major_attention,
                    "rope": ak.rope_attention}


def test_variant_wrappers_on_cpu_take_the_plain_version_and_count_nothing():
    before = [fn.launches for fn in ak.KERNELS]
    for kernel in VARIANT_WRAPPERS:
        out, ref = _variant_case(kernel, torch.float32, 8, 2, "cpu", p_len=48)
        assert torch.equal(out, ref), kernel
    assert [fn.launches for fn in ak.KERNELS] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CARD_CASES)
@pytest.mark.parametrize("hd,heads", [(64, 4), (32, 4), (16, 2)])
@pytest.mark.parametrize("kernel,p_len,block", [
    ("rw", 256, 0), ("rw", 64, 0), ("rw", 48, 0), ("rw", 32, 0),
    ("head major", 250, 0), ("head major", 37, 0), ("head major", 496, 16),
    ("rope", 250, 0), ("rope", 96, 16),
])
def test_variant_kernels_match_plain_on_card(cuda_device, dtype, tol, hd, heads, kernel, p_len,
                                             block):
    wrapper = VARIANT_WRAPPERS[kernel]
    before = wrapper.launches
    out, ref = _variant_case(kernel, dtype, hd, heads, cuda_device, p_len, block, seed=p_len)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("p_len", [256, 64])
def test_reduced_width_kernel_matches_the_two_phase_kernel_on_card(cuda_device, dtype, batch,
                                                                   p_len):
    """Kernel 6 computes kernel 2's function, and on the card it runs kernel
    2's body: the same bits, each wrapper counting its own launch."""
    ts = [_randn(batch, p_len, 256, seed=70 + i, device=cuda_device, dtype=dtype)
          for i in range(5)]
    before = (ak.local_two_phase_rw.launches, ak.local_two_phase.launches)
    out = ak.local_two_phase_rw(*ts, 4, 16)
    assert (ak.local_two_phase_rw.launches, ak.local_two_phase.launches) == (before[0] + 1,
                                                                             before[1])
    assert torch.equal(out, ak.local_two_phase(*ts, 4, 16))
    assert ak.local_two_phase.launches == before[1] + 1


@pytest.mark.cuda
def test_reduced_width_kernel_refuses_misaligned_buffers_on_card(cuda_device):
    """Kernel 2's body copies rows 16 bytes at a time: an input off 16 bytes
    is refused, nothing launched."""
    ts = [torch.zeros(2, 64, 64, device=cuda_device) for _ in range(5)]
    ts[2] = torch.zeros(1 + ts[2].numel(), device=cuda_device)[1:].view(2, 64, 64)
    before = ak.local_two_phase_rw.launches
    with pytest.raises(RuntimeError, match="misaligned"):
        ak.local_two_phase_rw(*ts, 4, 16)
    assert ak.local_two_phase_rw.launches == before


@pytest.mark.cuda
def test_variant_wrappers_are_differentiable_through_the_kernels_on_card(cuda_device):
    """Fault 1's check: the outputs carry a grad_fn.  Kernel 6's backward is
    kernel 7; kernels 3 and 10 differentiate their references."""
    before = [fn.launches for fn in ak.KERNELS]
    ts = [_randn(2, 64, 128, seed=80 + i, device=cuda_device).requires_grad_() for i in range(5)]
    out = ak.local_two_phase_rw(*ts, 2, 16)
    assert out.grad_fn is not None
    cot = _randn(2, 64, 128, seed=86, device=cuda_device)
    grads = torch.autograd.grad(out, ts, cot)
    _assert_grads_close(grads, ak.local_two_phase_grads_plain(
        *(t.detach() for t in ts), cot, 2, 16), 2e-5)

    q, k, v = (_randn(2, 2, 40, 64, seed=90 + i, device=cuda_device).requires_grad_()
               for i in range(3))
    out = ak.head_major_attention(q, k, v, 16)
    assert out.grad_fn is not None
    cot = _randn(2, 2, 40, 64, seed=93, device=cuda_device)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    refs = torch.autograd.grad(ak.head_major_attention_reference(*leaves, 16), leaves, cot)
    _assert_grads_close(torch.autograd.grad(out, (q, k, v), cot), refs, 2e-5)

    q, k, v = (_randn(2, 40, 128, seed=95 + i, device=cuda_device).requires_grad_()
               for i in range(3))
    cos, sin = _rope_tables(40, 64, cuda_device)
    out = ak.rope_attention(q, k, v, cos, sin, 2)
    assert out.grad_fn is not None
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    refs = torch.autograd.grad(ak.rope_attention_reference(*leaves, cos, sin, 2), leaves,
                               cot.transpose(1, 2).reshape(2, 40, 128))
    _assert_grads_close(torch.autograd.grad(out, (q, k, v), cot.transpose(1, 2).reshape(
        2, 40, 128)), refs, 2e-5)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip((fn.launches for fn in ak.KERNELS), before)]
    names = [fn.__name__ for fn in ak.KERNELS]
    assert dict(zip(names, launched)) == dict.fromkeys(names, 0) | dict(
        local_two_phase_rw=1, local_two_phase_grads=1, head_major_attention=1, rope_attention=1)


@pytest.mark.cuda
def test_variant_kernels_refuse_what_they_do_not_take_on_card(cuda_device):
    before = [fn.launches for fn in ak.KERNELS]
    for dtype, error in ((torch.float16, NotImplementedError), (torch.float32, ValueError)):
        hd = 64 if dtype == torch.float16 else 8   # hd 8 is not instantiated
        t = torch.zeros(1, 64, 2 * hd, device=cuda_device, dtype=dtype)
        cos, sin = _rope_tables(64, hd, cuda_device)
        with pytest.raises(error):
            ak.local_two_phase_rw(t, t, t, t, t, 2, 16)
        with pytest.raises(error):
            ak.head_major_attention(*(t.reshape(1, 64, 2, hd).transpose(1, 2).contiguous(),) * 3)
        with pytest.raises(error):
            ak.rope_attention(t, t, t, cos, sin, 2)
    f = torch.zeros(1, 56, 128, device=cuda_device)
    with pytest.raises(ValueError):  # P must be a multiple of the window
        ak.local_two_phase_rw(f, f, f, f, f, 2, 16)
    with pytest.raises(ValueError):  # a table shorter than S
        ak.rope_attention(f, f, f, *_rope_tables(55, 64, cuda_device), 2)
    assert [fn.launches for fn in ak.KERNELS] == before


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas", "pallas_rw"])
def test_f16_layers_run_on_the_card_and_launch_nothing(cuda_device, impl):
    """Fault 3: f16 takes the einsum routes, as in the JAX package."""
    cfg = dataclasses.replace(ModelConfig(), attention_impl=impl)
    att = pt_attention.SelfAttention(cfg, torch.Generator().manual_seed(0)).to(cuda_device)
    rope = pt_model.make_rope(cfg, cuda_device)
    x = _randn(2, 250, 256, seed=99, device=cuda_device, dtype=torch.float16)
    before = [fn.launches for fn in ak.KERNELS + flk.KERNELS + ck.KERNELS]
    with torch.no_grad():
        for layer in (pt_attention.self_attention, pt_attention.local_self_attention):
            out = layer(x, att, rope, cfg)
            assert out.dtype == torch.float16 and torch.isfinite(out).all()
            ref = layer(x.float(), att, rope, dataclasses.replace(cfg, attention_impl="xla"))
            assert (out.float() - ref).abs().max().item() <= 2e-2
    torch.cuda.synchronize()
    assert [fn.launches for fn in ak.KERNELS + flk.KERNELS + ck.KERNELS] == before


# --- the ConvNeXt stage kernels (kernels 20 and 19) ---------------------------


def _stage(depth, b, l, c, hidden, dtype, device="cpu", seed=0, taps=7):
    """Seeded (carries, weights, dy) of a stage: weights at the init's scales,
    gamma in (0.5, 1.5), each rounded to ``dtype`` (ln kept in fp32)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, generator=gen)
    uni = lambda scale, *shape: (torch.rand(*shape, generator=gen) * 2 - 1) * scale
    weights = [uni(taps ** -0.5, depth, taps, c), uni(taps ** -0.5, depth, 1, c),
               torch.stack([1 + 0.1 * randn(depth, c), 0.1 * randn(depth, c)], 1),
               uni(c ** -0.5, depth, c, hidden), uni(c ** -0.5, depth, 1, hidden),
               uni(hidden ** -0.5, depth, hidden, c), uni(hidden ** -0.5, depth, 1, c),
               0.5 + torch.rand(depth, 1, c, generator=gen)]
    weights = tuple((w.to(dtype).float() if n == "ln" else w.to(dtype)).to(device).contiguous()
                    for n, w in zip(ck.WEIGHT_NAMES, weights))
    carries = randn(depth, b, l, c).to(device=device, dtype=dtype)
    return carries, weights, randn(b, l, c).to(device=device, dtype=dtype)


def test_stage_wrappers_on_cpu_take_the_plain_version_and_count_nothing():
    before = [fn.launches for fn in ck.KERNELS]
    carries, weights, dy = _stage(2, 2, 12, 128, 256, torch.float32)
    dx, grads = ck.stage_bwd(carries, weights, dy)
    ref_dx, ref_grads = ck.stage_bwd_plain(carries, weights, dy)
    assert torch.equal(dx, ref_dx) and all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
    assert torch.equal(ck.stage_fwd(carries[0], weights), ck.stage_fwd_plain(carries[0], weights))
    assert [fn.launches for fn in ck.KERNELS] == before and len(ck.KERNELS) == 2


def test_stage_wrappers_refuse_other_devices():
    carries, weights, dy = _stage(1, 1, 8, 128, 256, torch.float32, device="meta")
    with pytest.raises(ValueError):
        ck.stage_bwd(carries, weights, dy)
    with pytest.raises(ValueError):
        ck.stage_fwd(dy, weights)


def test_stage_bwd_plain_is_the_gradient_of_the_blocks():
    """In f32 nothing rounds, so the plain backward is autograd's of the plain
    block loop up to the order of its sums."""
    carries, weights, dy = _stage(2, 2, 19, 128, 256, torch.float32, seed=1)
    leaves = [carries[0].clone().requires_grad_()] + [w.clone().requires_grad_() for w in weights]
    x, stack = leaves[0], []
    for d in range(2):
        stack.append(x.detach())
        x = ck.plain_block(x, leaves[1:], d)
    ref = torch.autograd.grad(x, leaves, dy)
    dx, grads = ck.stage_bwd_plain(torch.stack(stack), weights, dy)
    for out, r in zip((dx, *grads), ref):
        assert (out - r).abs().max() <= 2e-5 * r.abs().max()


# Stage kernels vs their plain versions, per output, as a share of its largest
# magnitude (f32: the same fp32 sums in another order) or in bf16 ulps of its
# top binade: a flipped rounding is one ulp, and the residual carries each
# block's flips into the next block's -- 3 ulps for up to 3 blocks, 8 for the
# 21 of stage 5 (read on an H100: 0.5 and 3).
def _stage_limit(ref: torch.Tensor, dtype, depth: int) -> float:
    top = ref.float().abs().max().item()
    if dtype == torch.float32:
        return 2e-5 * max(1.0, top)
    return (3 if depth <= 3 else 8) * 2.0 ** (math.ceil(math.log2(max(top, 2.0 ** -100))) - 8)


# The last three: rows (111, 519, 305) that are not a multiple of the
# backward's 128-row product tile nor of its depth tile, H = 384.
STAGE_GEOMETRIES = [(21, 2, 500, 128, 256), (3, 2, 250, 256, 512), (3, 2, 40, 128, 256),
                    (2, 3, 37, 128, 384), (3, 3, 173, 128, 384), (2, 5, 61, 256, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth,b,l,c,hidden", STAGE_GEOMETRIES)
def test_stage_bwd_kernel_matches_plain_on_card(cuda_device, dtype, depth, b, l, c, hidden):
    carries, weights, dy = _stage(depth, b, l, c, hidden, dtype, cuda_device, seed=l)
    before = ck.stage_bwd.launches
    dx, grads = ck.stage_bwd(carries, weights, dy)
    torch.cuda.synchronize()
    assert ck.stage_bwd.launches == before + 1
    ref_dx, ref_grads = ck.stage_bwd_plain(carries, weights, dy)
    assert dx.dtype == dtype and all(g.dtype == torch.float32 for g in grads)
    for name, out, ref in zip(("dx", *ck.WEIGHT_NAMES), (dx, *grads), (ref_dx, *ref_grads)):
        assert out.shape == ref.shape and torch.isfinite(out.float()).all(), name
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= _stage_limit(ref, dtype, depth), (name, err)
    again_dx, again = ck.stage_bwd(carries, weights, dy)
    assert torch.equal(again_dx, dx) and all(torch.equal(a, g) for a, g in zip(again, grads))


# The stage forward (kernel 19) also at the serving shapes of stages 4 and 5
# (16 windows; stage 5's 21 blocks update the output in place), at H = 196,
# whose bf16 rows (392 bytes) do not fill whole 16-byte pieces (the
# products' element copies), at C = 192 (a width its row kernel does not
# compile in) and at C = 3328 (tiles of 4 rows in f32, 8 in bf16: 16 rows do
# not fit in shared memory).
STAGE_FWD_GEOMETRIES = STAGE_GEOMETRIES + [(3, 2, 1000, 64, 128), (3, 16, 1000, 64, 128),
                                           (21, 16, 500, 128, 256), (2, 3, 37, 128, 196),
                                           (3, 2, 40, 64, 196), (2, 2, 40, 192, 384),
                                           (1, 1, 16, 3328, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth,b,l,c,hidden", STAGE_FWD_GEOMETRIES)
def test_stage_fwd_kernel_matches_plain_on_card(cuda_device, dtype, depth, b, l, c, hidden):
    carries, weights, _ = _stage(depth, b, l, c, hidden, dtype, cuda_device, seed=l + 1)
    x = carries[0].contiguous()
    before = ck.stage_fwd.launches
    out = ck.stage_fwd(x, weights)
    torch.cuda.synchronize()
    assert ck.stage_fwd.launches == before + 1
    ref = ck.stage_fwd_plain(x, weights)
    assert out.dtype == dtype and out.shape == x.shape and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= _stage_limit(ref, dtype, depth)
    assert torch.equal(ck.stage_fwd(x, weights), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_fwd_off_16_bytes_gives_the_aligned_bits_on_card(cuda_device, dtype):
    """An x that does not start on 16 bytes takes the element copies, whose
    sums run in the same order: the aligned call's bits."""
    carries, weights, _ = _stage(2, 2, 40, 128, 256, dtype, cuda_device, seed=9)
    x = carries[0].contiguous()
    shifted = torch.empty(1 + x.numel(), dtype=dtype, device=cuda_device)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    assert torch.equal(ck.stage_fwd(shifted, weights), ck.stage_fwd(x, weights))


@pytest.mark.cuda
def test_stage_functions_differentiate_through_the_kernels_on_card(cuda_device):
    carries, weights, dy = _stage(3, 2, 40, 128, 256, torch.float32, cuda_device, seed=3)
    x = carries[0].contiguous()

    def grads_of(fn):
        leaves = [x.clone().requires_grad_()] + [w.clone().requires_grad_() for w in weights]
        out = fn(leaves[0], leaves[1:])
        return out, torch.autograd.grad(out, leaves, dy)

    ref_out, ref = grads_of(ck.plain_stage)
    before = [fn.launches for fn in ck.KERNELS]
    out, mine = grads_of(ck.stage_blocks_fused_bwd)
    assert [fn.launches for fn in ck.KERNELS] == [before[0] + 1, before[1]]
    assert torch.equal(out, ref_out)
    for a, r in zip(mine, ref):
        assert a.dtype == r.dtype and (a - r).abs().max() <= 2e-5 * max(1.0, r.abs().max())
    out, mine = grads_of(ck.fused_convnext_stage)
    assert [fn.launches for fn in ck.KERNELS] == [before[0] + 1, before[1] + 1]
    assert (out - ref_out).abs().max() <= 2e-5 * ref_out.abs().max()
    for a, r in zip(mine, ref):
        assert torch.equal(a, r)   # autograd of the plain blocks from the saved input
    with torch.no_grad():
        assert torch.equal(ck.stage_blocks_fused_bwd(x, weights), ref_out)
    assert ck.stage_bwd.launches == before[0] + 1


@pytest.mark.cuda
def test_stage_kernels_refuse_what_they_do_not_take_on_card(cuda_device):
    carries, weights, dy = _stage(2, 2, 16, 128, 256, torch.float32, cuda_device)
    before = [fn.launches for fn in ck.KERNELS]
    half = tuple(w if n == "ln" else w.half() for n, w in zip(ck.WEIGHT_NAMES, weights))
    with pytest.raises(NotImplementedError):
        ck.stage_bwd(carries.half(), half, dy.half())
    with pytest.raises(NotImplementedError):
        ck.stage_fwd(dy.half(), half)
    five = _stage(2, 2, 16, 128, 256, torch.float32, cuda_device, taps=5)
    with pytest.raises(ValueError, match="taps"):
        ck.stage_bwd(*five)
    with pytest.raises(ValueError, match="taps"):
        ck.stage_fwd(five[2], five[1])
    with pytest.raises(ValueError):                     # carries of another depth
        ck.stage_bwd(carries[:1], weights, dy)
    with pytest.raises(ValueError):                     # not contiguous
        ck.stage_fwd(dy.transpose(0, 1), weights)
    with pytest.raises(ValueError):                     # bf16 rows, f32 weights
        ck.stage_fwd(dy.bfloat16(), weights)
    with pytest.raises(ValueError):                     # channels that are not the weights'
        ck.stage_fwd(dy[..., :64].contiguous(), weights)
    assert [fn.launches for fn in ck.KERNELS] == before


# ---------------------------------------------------------------------------
# The fused transformer-layer kernels: 11 (attention block), 18 (attention
# sublayers), 17 (pair), at the default widths (D 256, 4 heads x 64, kv 64,
# FFN 512).
# ---------------------------------------------------------------------------

from audio_to_midi_tpu_torch.config import ModelConfig  # noqa: E402
from audio_to_midi_tpu_torch.models import attention as pt_attention  # noqa: E402
from audio_to_midi_tpu_torch.models import model as pt_model  # noqa: E402
from audio_to_midi_tpu_torch.models import transformer as pt_transformer  # noqa: E402
from audio_to_midi_tpu_torch.ops import fused_layer_kernels as flk  # noqa: E402

FUSED_CFG = ModelConfig()
FUSED_CASES = ("block local", "block global", "local sublayer", "global sublayer", "pair")


def _fused_outputs(case: str, seq: int, batch: int, dtype, device="cpu", seed=0):
    """(wrapper output, plain version's output) of one case on seeded inputs
    and a seeded pair whose LayerNorms are off the identity."""
    # By the name pytest imports the test files under (see above).
    from test_torch_fused_mma import fused_call

    wrapper, plain, args, kwargs = fused_call(case, FUSED_CFG, seq, batch, dtype, device, seed)
    with torch.no_grad():
        return wrapper(*args, **kwargs), plain(*args, **kwargs)


def test_fused_wrappers_on_cpu_take_the_plain_version_and_count_nothing():
    before = [fn.launches for fn in flk.KERNELS]
    for case in FUSED_CASES:
        out, ref = _fused_outputs(case, 58, 1, torch.float32)
        assert torch.equal(out, ref), case
    assert [fn.launches for fn in flk.KERNELS] == before and len(flk.KERNELS) == 4


def test_fused_wrappers_refuse_other_devices():
    x = torch.zeros(1, 64, 256, device="meta")
    w = torch.zeros(256, 256, device="meta")
    with pytest.raises(ValueError):
        flk.attention_block(x, w, w, w, w, w, w, w, 4, 64, 16)
    with pytest.raises(ValueError):
        flk.fused_local_sublayer(x, (), (w,) * 4, num_heads=4, valid_len=58, pad_l=3, window=16)
    with pytest.raises(ValueError):
        flk.fused_global_sublayer(x, (), (w,) * 2, num_heads=4, valid_len=58, pad_l=3)
    with pytest.raises(ValueError):
        flk.transformer_pair(x, (), (), num_heads=4, valid_len=58, pad_l=3, window=16)


# Kernels 11, 17, 18 vs their plain versions: f32 as CARD_CASES (the same fp32
# sums in another order); bf16 the same 2e-2, or 2 ulps of the output's top
# binade where that is larger: kernels 17 and 18 return the residual stream
# (magnitudes up to ~5 here, one ulp 0.031), and a rounding flipped by a sum
# taken in another order moves an output by one ulp.
def _fused_limit(ref: torch.Tensor) -> float:
    if ref.dtype == torch.float32:
        return 1e-5
    top = ref.float().abs().max().item()
    return max(2e-2, 2 * 2.0 ** (math.ceil(math.log2(max(top, 2.0 ** -100))) - 8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq,batch", [(250, 16), (58, 3)])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_layer_kernels_match_plain_on_card(cuda_device, dtype, seq, batch, case):
    before = sum(fn.launches for fn in flk.KERNELS)
    out, ref = _fused_outputs(case, seq, batch, dtype, cuda_device, seed=seq)
    torch.cuda.synchronize()
    assert sum(fn.launches for fn in flk.KERNELS) == before + 1
    assert out.dtype == dtype and out.shape == ref.shape and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= _fused_limit(ref)
    again, _ = _fused_outputs(case, seq, batch, dtype, cuda_device, seed=seq)
    assert torch.equal(again, out)  # the same inputs give the same bits
    if case in ("local sublayer", "global sublayer", "pair"):
        pad_l = pt_attention._local_padding(seq, 16)[0]
        assert not out[:, :pad_l].any() and not out[:, pad_l + seq:].any()


@pytest.mark.cuda
def test_fused_layer_kernels_refuse_what_they_do_not_take_on_card(cuda_device):
    before = [fn.launches for fn in flk.KERNELS]
    for case in FUSED_CASES:
        with pytest.raises(NotImplementedError):
            _fused_outputs(case, 58, 1, torch.float16, cuda_device)
    pair = pt_transformer.AlternatingLayer(FUSED_CFG, torch.Generator().manual_seed(0))
    pair = pair.to(cuda_device)
    rope = pt_model.make_rope(FUSED_CFG, cuda_device)
    x = torch.zeros(2, 250, 256, device=cuda_device)          # P = 250: not a multiple of 16
    tables = pt_transformer._pair_rope_tables(rope, FUSED_CFG, 250, 0)
    geometry = dict(num_heads=4, valid_len=250, pad_l=0)
    with pytest.raises(ValueError):
        flk.transformer_pair(x, flk.pair_weights(pair, torch.float32), tables, window=16,
                             **geometry)
    with pytest.raises(ValueError):
        flk.fused_global_sublayer(x, flk.sublayer_weights(pair.get_submodule("global"),
                                                          torch.float32), tables[4:], **geometry)
    att = pair.get_submodule("local").attention
    ws = [lin.w for lin in (att.q_up, att.kv_down, att.k_up, att.v_up, att.out)]
    cos, sin = pt_attention._rope_tables(rope, 256, 0)
    with pytest.raises(ValueError):                            # 32 heads of 8
        flk.attention_block(x, *ws, cos, sin, 32, 250, 0)
    with pytest.raises(ValueError):                            # P = 250 is not a multiple of 8
        flk.attention_block(x, *ws, cos, sin, 4, 250, 16)
    with pytest.raises(ValueError):                            # bf16 rows, f32 weights
        flk.attention_block(x.bfloat16(), *ws, cos, sin, 4, 250, 0)
    assert [fn.launches for fn in flk.KERNELS] == before


# Kernels 11, 17 and 18 against the emulation of their tensor-core arithmetic
# (tests/test_torch_fused_mma.py, run on the card: 3xTF32 products in f32,
# the global core's weights rounded after the whole row), at the limits they
# are held to against the plain versions; at widths that do not fill 16-byte
# pieces (kv 50, FFN 298: the products copy element by element); on an x that
# does not start on 16 bytes; and the operands the model paths hand them.


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq,batch", [(250, 16), (58, 3)])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_layer_kernels_match_their_emulation_on_card(cuda_device, dtype, seq, batch, case):
    # By the name pytest imports the test files under (see above).
    from test_torch_fused_mma import emulate, fused_call

    wrapper, plain, args, kwargs = fused_call(case, FUSED_CFG, seq, batch, dtype, cuda_device,
                                              seed=seq)
    with torch.no_grad():
        out = wrapper(*args, **kwargs)
    emulated = emulate(plain, *args, **kwargs)
    torch.cuda.synchronize()
    assert out.dtype == emulated.dtype and out.shape == emulated.shape
    assert (out.float() - emulated.float()).abs().max().item() <= _fused_limit(emulated)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_layer_kernels_take_widths_off_16_bytes_on_card(cuda_device, dtype, case):
    """kv 50 and FFN 298 (rows of 100 and 596 bytes in bf16, 200 and 1192 in
    f32): the entries take them, as before the products moved to the tensor
    cores; the same inputs give the same bits, padding rows stay zero."""
    from test_torch_fused_mma import RAGGED_CFG, emulate, fused_call

    wrapper, plain, args, kwargs = fused_call(case, RAGGED_CFG, 58, 3, dtype, cuda_device, seed=5)
    before = wrapper.launches
    with torch.no_grad():
        out, again = wrapper(*args, **kwargs), wrapper(*args, **kwargs)
        ref = plain(*args, **kwargs)
    emulated = emulate(plain, *args, **kwargs)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert out.dtype == dtype and out.shape == ref.shape and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= _fused_limit(ref)
    assert (out.float() - emulated.float()).abs().max().item() <= _fused_limit(emulated)
    assert torch.equal(out, again)
    if not case.startswith("block"):
        pad_l = pt_attention._local_padding(58, 16)[0]
        assert not out[:, :pad_l].any() and not out[:, pad_l + 58:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["block global", "global sublayer", "pair"])
def test_fused_layer_kernels_take_an_x_off_16_bytes_on_card(cuda_device, dtype, case):
    """An x one element past a 16-byte boundary: the products that read it
    copy it element by element, in the same order of sums, so the output
    has the bits of the aligned call."""
    from test_torch_fused_mma import fused_call

    wrapper, _, args, kwargs = fused_call(case, FUSED_CFG, 58, 3, dtype, cuda_device, seed=6)
    x = args[0]
    shifted = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    with torch.no_grad():
        out, ref = wrapper(shifted, *args[1:], **kwargs), wrapper(*args, **kwargs)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl", ["pallas_block", "pallas_fused", "pallas_pair"])
def test_model_paths_hand_the_fused_kernels_16_byte_operands_on_card(cuda_device, monkeypatch,
                                                                     dtype, impl):
    """Every tensor the transformer stack hands kernels 11, 17 and 18 at the
    default widths starts on 16 bytes and holds rows of whole 16-byte pieces,
    so no model path takes the products' element copies."""
    seen = []
    for kernel in flk.KERNELS:
        @functools.wraps(kernel)  # keeps .launches, which the wrappers count by their name
        def recording(*args, _kernel=kernel, **kwargs):
            for a in args:
                for t in a if isinstance(a, (tuple, list)) else (a,):
                    if isinstance(t, torch.Tensor):
                        seen.append((t.data_ptr(), t.shape[-1] * t.element_size()))
            return _kernel(*args, **kwargs)
        monkeypatch.setattr(flk, kernel.__name__, recording)
    cfg = dataclasses.replace(FUSED_CFG, attention_impl=impl, num_transformer_layers=2)
    stack = pt_transformer.TransformerStack(cfg, torch.Generator().manual_seed(1))
    stack = stack.to(device=cuda_device, dtype=dtype)
    x = _randn(4, 250, cfg.transformer_hidden_dim, seed=8, device=cuda_device, dtype=dtype)
    with torch.no_grad():
        out = pt_transformer.transformer_stack(x, stack, pt_model.make_rope(cfg, cuda_device), cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and len(seen) > 0
    assert all(ptr % 16 == 0 and row_bytes % 16 == 0 for ptr, row_bytes in seen), seen


# ---------------------------------------------------------------------------
# Kernel 10 on kernel 1's body: the same bits, the weights rounded as kernel
# 1 (and the TPU kernel) rounds them.
# ---------------------------------------------------------------------------


def _roped(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int) -> torch.Tensor:
    """The plain rotation (fp32 products and difference, cast back)."""
    return ak._rope_rows(t, cos, sin, heads).reshape(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,heads", [(64, 4), (32, 4), (16, 2)])
@pytest.mark.parametrize("s,block", [(250, 0), (496, 16), (37, 0)])
def test_rope_kernel_gives_kernel_1_bits_on_roped_inputs_on_card(cuda_device, dtype, hd, heads,
                                                                 s, block):
    q, k, v = (_randn(16, s, heads * hd, seed=s + hd + i, device=cuda_device, dtype=dtype)
               for i in range(3))
    cos, sin = _rope_tables(s + 3, hd, cuda_device)
    before = (ak.rope_attention.launches, ak.global_attention.launches)
    out = ak.rope_attention(q, k, v, cos, sin, heads, block)
    assert (ak.rope_attention.launches, ak.global_attention.launches) == (before[0] + 1, before[1])
    ref = ak.global_attention(_roped(q, cos, sin, heads), _roped(k, cos, sin, heads), v, heads,
                              block)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def _rounded_weights_attention(q, k, v, heads: int) -> torch.Tensor:
    """Kernel 1's bf16 arithmetic on the CPU, without masks: q scaled in its
    dtype, fp32 logits, an online softmax over 64-column tiles whose
    unnormalised weights exp(s - m) are rounded to bf16 before their product
    with v (the TPU kernels' weights.astype(v.dtype)), the fp32 row sum
    unrounded, the division at the end."""
    g, s, dm = q.shape
    hd = dm // heads
    split = lambda t: t.reshape(g, s, heads, hd).transpose(1, 2).float()
    logits = split(q * torch.tensor(1 / math.sqrt(hd), dtype=q.dtype)) @ split(k).transpose(-1, -2)
    vf = split(v)
    m = torch.full((g, heads, s, 1), -torch.inf)
    row_sum = torch.zeros(g, heads, s, 1)
    acc = torch.zeros(g, heads, s, hd)
    for k0 in range(0, s, 64):
        tile = logits[..., k0:k0 + 64]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(tile - m_new)
        row_sum = row_sum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vf[..., k0:k0 + 64, :]
        m = m_new
    return (acc / row_sum).transpose(1, 2).reshape(g, s, dm).to(q.dtype)


@pytest.mark.cuda
def test_rope_kernel_rounds_bf16_weights_as_the_tpu_kernel_on_card(cuda_device):
    """In bf16 kernel 10 rounds each tile's weights before their product
    with v.  Its outputs equal the rounded-weight arithmetic's on >= 99 % of
    the elements (sums in another order flip ~0.05 %, read on the CPU
    between fp32 and fp64 accumulation); fp32 weights -- the plain version,
    and kernel 10 before it moved onto kernel 1's body -- give another bf16
    output on ~39 % of them, and fail the same check."""
    q, k, v = (_randn(16, 250, 256, seed=300 + i, dtype=torch.bfloat16) for i in range(3))
    cos, sin = _rope_tables(250, 64, "cpu")
    out = ak.rope_attention(*(t.to(cuda_device) for t in (q, k, v)), cos.to(cuda_device),
                            sin.to(cuda_device), 4).cpu()
    rounded = _rounded_weights_attention(_roped(q, cos, sin, 4), _roped(k, cos, sin, 4), v, 4)
    fp32_weights = ak.rope_attention_plain(q, k, v, cos, sin, 4)
    share = lambda a: (a == rounded).float().mean().item()
    assert share(out) >= 0.99
    assert share(fp32_weights) < 0.9


# ---------------------------------------------------------------------------
# The eventizer's kernel (csrc/eventize.cu) against its plain version.
# ---------------------------------------------------------------------------

from audio_to_midi_tpu_torch.ops import eventize as ev  # noqa: E402


def _event_probs(case: str, frames: int, keys: int = 90) -> "np.ndarray":
    import numpy as np

    rng = np.random.default_rng(frames * 7 + len(case))
    if case == "walk":  # random-walk probabilities that cross every threshold
        logits = np.cumsum(rng.standard_normal((frames, keys)) * 0.8, axis=0)
        return (1 / (1 + np.exp(-(logits - logits.mean(0))))).astype(np.float32)
    if case == "uniform":
        return rng.random((frames, keys)).astype(np.float32)
    if case in ("zeros", "ones"):
        return np.full((frames, keys), float(case == "ones"), np.float32)
    p = _event_probs("walk", frames, keys)
    if case == "held to the end":
        p[3:, 0] = 0.9
        p[frames - 1, 1] = 0.51
    elif case == "nan rows":
        p[7] = np.nan
        p[20:23, 2] = np.nan
    elif case == "at the thresholds":
        p[:, :4] = np.float32([0.5, 0.1, 0.4, 0.5])
    return p


EVENT_CASES = ([("walk", n, 90) for n in (1, 2, 3, 4, 5, 6, 7, 250, 3000, 15_000)]
               + [("uniform", 250, 90), ("uniform", 3000, 90), ("walk", 300, 8),
                  ("walk", 300, 33), ("zeros", 40, 8), ("ones", 40, 8),
                  ("held to the end", 40, 8), ("nan rows", 40, 8),
                  ("at the thresholds", 40, 8)])


@pytest.mark.cuda
@pytest.mark.parametrize("case,frames,keys", EVENT_CASES)
def test_eventize_kernel_matches_plain_on_card(cuda_device, case, frames, keys):
    """The five dense arrays, bit for bit (IEEE sums and divisions on both
    sides), for any number of frames and keys (a block takes 32 keys)."""
    p = _event_probs(case, frames, keys)
    before = ev.eventize.launches
    out = ev.eventize(torch.from_numpy(p).to(cuda_device))
    torch.cuda.synchronize()
    assert ev.eventize.launches == before + 1
    for o, r in zip(out, ev.extract_events_dense_plain(p)):
        r = torch.from_numpy(r)
        assert o.device.type == "cuda" and o.dtype == r.dtype
        assert torch.equal(o.cpu(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [250, 15_000])
def test_event_lists_of_a_cuda_tensor_never_reach_numpy_on_card(cuda_device, monkeypatch,
                                                               frames):
    """A CUDA tensor is eventized by the kernel: with the plain version made
    to raise, the event lists (both velocity modes) and the compact table
    equal the plain ones, one launch each."""
    p = _event_probs("walk", frames)
    refs = (ev.extract_events(p), ev.extract_events(p, real_velocity=True),
            ev.extract_events_compact(p, 2 * frames))

    def refuse(_):
        raise AssertionError("a CUDA tensor reached the plain eventizer")

    monkeypatch.setattr(ev, "extract_events_dense_plain", refuse)
    pc = torch.from_numpy(p).to(cuda_device)
    before = ev.eventize.launches
    events = ev.extract_events(pc)
    assert events == refs[0] and len(events) > 0
    assert ev.extract_events(pc, real_velocity=True) == refs[1]
    table, count, active, started = ev.extract_events_compact(pc, 2 * frames)
    assert table.device.type == "cuda" and count == refs[2][1]
    for o, r in zip((table, active, started), (refs[2][0], *refs[2][2:])):
        assert torch.equal(o.cpu(), r)
    assert ev.eventize.launches == before + 3


@pytest.mark.cuda
def test_eventize_refuses_what_it_does_not_take_on_card(cuda_device):
    before = ev.eventize.launches
    with pytest.raises(ValueError):
        ev.eventize(torch.zeros(0, 90, device=cuda_device))
    with pytest.raises(ValueError):
        ev.eventize(torch.zeros(5, device=cuda_device))
    with pytest.raises(ValueError):  # past 2^24 frames float(frame) is not exact
        ev.eventize(torch.zeros(ev.MAX_FRAMES + 1, 1, device=cuda_device))
    assert ev.eventize.launches == before


# --- the training feed on the card: device augmentation and input ring ----


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_augmentation_waves_equal_the_sequential_version_on_card(cuda_device, seed):
    """The default transforms on a batch of 64 full windows: the waves give
    the sequential plain version's bits on the card."""
    from audio_to_midi_tpu_torch.config import TransformSettings
    from audio_to_midi_tpu_torch.data import augment_device as ad

    audio = _randn(64, 2, 80_000, seed=seed, device=cuda_device)
    labels = torch.rand(64, 250, 90, generator=torch.Generator().manual_seed(seed)).to(cuda_device)
    draws = ad.draw(TransformSettings(), 64, 80_000, 250, torch.Generator().manual_seed(seed),
                    cuda_device)
    a1, l1, a2, l2 = audio.clone(), labels.clone(), audio.clone(), labels.clone()
    ad.augment_(a1, l1, draws)
    ad.augment_sequential(a2, l2, draws)
    assert not torch.equal(a1, audio)
    assert torch.equal(a1, a2) and torch.equal(l1, l2)


@pytest.mark.cuda
def test_ring_refresh_waits_for_the_pending_gather_on_card(cuda_device):
    """A push into slots that a queued gather still reads lands after it; a
    sample after the push sees the new chunk (its copy runs on a side
    stream)."""
    import numpy as np

    from audio_to_midi_tpu_torch.data.device_ring import DeviceInputRing

    def chunk(value):
        audio = torch.full((4, 2, 4096), value, dtype=torch.float16).pin_memory()
        labels = torch.full((4, 8, 90), value, dtype=torch.float16).pin_memory()
        return audio, labels

    ring = DeviceInputRing(capacity=4, chunk_windows=4, device=cuda_device)
    ring.push(*chunk(1.0))
    gen = torch.Generator().manual_seed(0)
    torch.cuda._sleep(200_000_000)  # hold the training stream: the gather stays queued
    old_audio, old_labels = ring.sample(gen, batch=8, minibatch=4, settings=None)
    ring.push(*chunk(2.0))  # the same slots
    new_audio, new_labels = ring.sample(gen, batch=8, minibatch=4, settings=None)
    torch.cuda.synchronize()
    assert np.unique(old_audio.cpu().numpy()).tolist() == [1.0]
    assert np.unique(old_labels.cpu().numpy()).tolist() == [1.0]
    assert np.unique(new_audio.cpu().numpy()).tolist() == [2.0]
    assert np.unique(new_labels.cpu().numpy()).tolist() == [2.0]


@pytest.mark.cuda
def test_ring_first_push_lands_after_the_pool_fill_on_card(cuda_device):
    """The pool is allocated and zero-filled on the training stream inside
    the first push; the side stream's copy of that push must land after
    the fill, even while the training stream is held back."""
    import numpy as np

    from audio_to_midi_tpu_torch.data.device_ring import DeviceInputRing

    audio = torch.full((4, 2, 4096), 3.0, dtype=torch.float16).pin_memory()
    labels = torch.full((4, 8, 90), 3.0, dtype=torch.float16).pin_memory()
    ring = DeviceInputRing(capacity=4, chunk_windows=4, device=cuda_device)
    # The pool's fill once beforehand: its blocks then come from the
    # allocator's cache and its kernel is loaded.  A fresh cudaMalloc or a
    # kernel's first load may wait for the card and so hide the race.
    for t in (audio, labels):
        torch.zeros(t.shape, dtype=t.dtype, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # hold the training stream: the fill stays queued
    ring.push(audio, labels)  # allocates the pool
    got_audio, got_labels = ring.sample(torch.Generator().manual_seed(0), batch=8, minibatch=4,
                                        settings=None)
    torch.cuda.synchronize()
    assert np.unique(got_audio.cpu().numpy()).tolist() == [3.0]
    assert np.unique(got_labels.cpu().numpy()).tolist() == [3.0]
