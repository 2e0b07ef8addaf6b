"""The attention kernel wrappers of the PyTorch port, without JAX.

This file imports no JAX, so it also runs where only PyTorch is installed.
On the CPU it checks the wrappers' routing; the ``cuda``-marked tests hold
each CUDA kernel against its plain version on the card and skip where there
is no CUDA device.  On a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

(``--noconftest``: the repository's conftest configures JAX.)
"""

import pytest
import torch

from audio_to_midi_tpu_torch.ops import attention_kernels as ak

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
# only in summation order (fp32 accumulation on both sides); bf16 outputs
# round to 8 mantissa bits, one ulp near 1 is 2**-7 = 7.8e-3, and the
# kernel keeps the softmax weights in fp32 where the plain version does too
# but sums in another order.
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
