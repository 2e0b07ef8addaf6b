"""The resampler's kernel (``csrc/resample.cu``) as far as the CPU can hold it.

The kernel runs only on the card (``chip_smoke.py`` holds it there against
the plain path bit for bit).  Here: the index arithmetic it uses, stated once
in ``ops/frontend.resample_taps``, against the plain path's table of first
taps for every output and tap, with the block's shared tile holding every
tap it reads; the weights; the CPU path and the launch count; the wrapper's
refusals.
"""

import math

import numpy as np
import pytest
import torch

from audio_to_midi_tpu_torch.ops import frontend

torch.set_num_threads(2)

RATES = (44_100, 48_000, 22_050, 8_000)  # -> 16 kHz; 8 kHz upsamples


def _reduced(src: int) -> tuple[int, int]:
    g = math.gcd(16_000, src)
    return 16_000 // g, src // g


def _lengths(src: int) -> list[int]:
    """1, up - 1, the first N with an output past a block, and 2 s."""
    up, down = _reduced(src)
    block = frontend.resample_geometry(up, down)[1]
    return sorted({1, max(1, up - 1), block * down // up + 1, 2 * src})


def _table(n: int, up: int, down: int, taps: int) -> np.ndarray:
    """The plain path's first taps, unpadded: start(r) + q * down for output
    m = q * up + r, as ``resample_poly_plain`` builds them."""
    pad = taps * up // 2
    out_len = -(-n * up // down)
    r = np.arange(up)
    j0 = (pad - r * down) % up
    start = (r * down + j0 - pad) // up
    q_len = -(-out_len // up)
    return (start[None, :] + down * np.arange(q_len)[:, None]).reshape(-1)[:out_len]


@pytest.mark.parametrize("src,n", [(src, n) for src in RATES for n in _lengths(src)])
@pytest.mark.parametrize("block", [None, 1024, 64, 1])  # None: the kernel's (960 at 44.1 kHz)
def test_resample_taps_is_the_plain_table_for_every_output_and_tap(src, n, block):
    up, down = _reduced(src)
    taps = 16
    first = _table(n, up, down, taps)
    m = np.arange(first.size)
    got, phase = frontend.resample_taps(m, up, down, taps, block)
    np.testing.assert_array_equal(got, first)
    np.testing.assert_array_equal(phase, m % up)
    np.testing.assert_array_equal(got[:, None] + np.arange(taps), first[:, None] + np.arange(taps))
    # One output at a time, as Python ints: the same numbers.
    for i in (0, first.size // 2, first.size - 1):
        assert frontend.resample_taps(int(i), up, down, taps, block) == (first[i], i % up)
    # Every block's taps lie in the span the kernel stages for it:
    # ceil((block - 1) * down / up) + taps samples from its first tap.
    block = block or frontend.resample_geometry(up, down, taps)[1]
    span = -(-(block - 1) * down // up) + taps
    for b0 in range(0, first.size, block):
        f = got[b0: b0 + block]
        assert f.min() == f[0] and f.max() + taps - f[0] <= span


@pytest.mark.parametrize("up,down", [(160, 441), (1, 3), (320, 441), (2, 1), (1, 1000),
                                     (16_001, 44_100), (3, 7)])
def test_resample_geometry_gives_one_phase_a_thread_and_fits_the_tile(up, down):
    threads, outputs = frontend.resample_geometry(up, down)
    assert 1 <= threads <= 1024 and outputs >= 1
    if up <= 1024:  # a thread's outputs, `threads` apart, share a phase
        assert threads % up == 0 and threads > 128
    span = -(-(outputs - 1) * down // up) + 16
    assert (span + 6) // 4 * 16 <= frontend.TILE_BYTES
    if down <= 3 * up:  # the rates that serve: whole blocks of about 1024 outputs
        assert outputs % threads == 0 and 900 <= outputs <= 1024
    assert max(outputs, threads) * down + up < 2**32


def test_resample_geometry_refuses_taps_beyond_the_tile():
    with pytest.raises(ValueError):
        frontend.resample_geometry(160, 441, taps_per_phase=13_000)


@pytest.mark.parametrize("src", RATES)
def test_phase_weights_are_the_reversed_filter_at_each_phase(src):
    up, down = _reduced(src)
    taps = 16
    w = frontend._phase_weights(up, down, taps)
    h = frontend._kaiser_sinc_filter(taps * up, 0.5 / max(up, down)) * np.float32(up)
    assert w.shape == (taps, up) and w.dtype == np.float32
    j0 = (taps * up // 2 - np.arange(up) * down) % up
    for t in (0, 7, taps - 1):
        np.testing.assert_array_equal(w[t], h[::-1][j0 + t * up])


@pytest.mark.parametrize("src", RATES)
def test_cpu_tensors_take_the_plain_path_and_count_nothing(src):
    before = frontend.resample.launches
    x = torch.from_numpy((np.random.default_rng(src).standard_normal((2, 3001)) * 0.3)
                         .astype(np.float32))
    up, down = _reduced(src)
    out = frontend.resample_poly(x, 16_000, src)
    assert torch.equal(out, frontend.resample_poly_plain(x, up, down))
    assert out.shape == (2, -(-3001 * up // down))
    assert frontend.resample.launches == before
    assert frontend.KERNELS == (frontend.resample,)


def test_the_kernel_wrapper_refuses_other_devices():
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError):
            frontend.resample(torch.zeros(2, 100, device=device), 160, 441)


@pytest.mark.cuda
def test_the_kernel_wrapper_refuses_non_contiguous_or_non_f32_cuda_samples():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is CUDA C++ with no CPU mode)")
    before = frontend.resample.launches
    x = torch.zeros(2, 1000, device="cuda")
    for bad in (x[:, ::2], x.T, x.double(), x.bfloat16()):
        with pytest.raises(ValueError):
            frontend.resample(bad, 160, 441)
        with pytest.raises(ValueError):
            frontend.resample_poly(bad, 16_000, 44_100)
    assert frontend.resample.launches == before
