"""Audio frontend on tensors: resampling, loudness normalization and window
slicing.

Counterpart of ``make_windows``, ``slice_full_audio``, ``normalize_loudness``,
``resample_poly``, ``prepare_windows`` and ``fft_audio`` in
``audio_to_midi_tpu/ops/frontend.py``.  They run on whatever device the
samples lie on; on the card the resampler is the kernel of
``csrc/resample.cu`` (:func:`resample`).  ``split_training_windows`` is the
numpy host helper of the same file.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import span
from . import cuda_build


def normalize_loudness(samples: torch.Tensor) -> torch.Tensor:
    """Unit-variance normalization over both channels with a silence guard.

    samples: (2, N).  If max |s| <= 0.05 the audio is left as it is;
    otherwise it is scaled by 1/sqrt(mean(s^2)) over both channels jointly.
    """
    x = samples.float()
    peak = x.abs().max()
    variance = x.square().mean()
    adjustment = torch.where(peak <= 0.05, torch.ones_like(variance), torch.rsqrt(variance))
    return (x * adjustment).to(samples.dtype)


def split_training_windows(samples: np.ndarray,
                           window_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Non-overlapping training splits with the reference's drop rule.

    samples: (2, N) numpy ->
      windows: (S, 2, window_size), zero-padded,
      keep:    (S,) bool, True iff the split has MORE than half real samples
               (python.rs:517),
      backing: (S,) int, the number of real (not padded) samples per split.
    """
    n = samples.shape[1]
    num_splits = max(1, math.ceil(n / window_size))
    out = np.zeros((num_splits, 2, window_size), samples.dtype)
    backing = np.zeros((num_splits,), np.int64)
    for s in range(num_splits):
        start = s * window_size
        take = min(window_size, n - start)
        out[s, :, :take] = samples[:, start:start + take]
        backing[s] = take
    return out, backing > window_size // 2, backing


def make_windows(samples: torch.Tensor, window_size: int, overlap_samples: int) -> torch.Tensor:
    """(2, N) -> (W, 2, window_size) overlapping windows, the last zero-padded.

    Windows start every ``window_size - overlap_samples`` samples and W is
    ``max(1, ceil((N - overlap) / step))``.
    """
    step = window_size - overlap_samples
    n = samples.shape[1]
    n_windows = max(1, math.ceil((n - overlap_samples) / step))
    pad_to = (n_windows - 1) * step + window_size
    padded = F.pad(samples, (0, max(0, pad_to - n)))
    return padded.unfold(1, window_size, step).transpose(0, 1).contiguous()


def slice_full_audio(samples: torch.Tensor, sample_rate: int, window_duration: float,
                     overlap: float) -> tuple[torch.Tensor, float]:
    """(2, N) audio -> ((W, 2, window) overlapping model windows, the last
    zero-padded, window_duration), on the samples' device; the overlap and
    the window duration in seconds (reference
    audio_to_midi_dataset.py:277-294)."""
    window_size = round(window_duration * sample_rate)
    return make_windows(samples, window_size, round(overlap * sample_rate)), window_duration


def fft_audio(signal: torch.Tensor, window_size: int, overlap: float = 0.5) -> torch.Tensor:
    """The legacy spectrogram (reference audio_to_midi_dataset.py:58-107),
    kept for tooling: the whole input read as one sequence, whole frames
    every ``window_size * (1 - overlap)`` samples under the window
    exp(-0.001 n), the complex abs taken by hand and scaled by 1/180.
    Returns (window_size // 2 + 1, frames) on the signal's device."""
    if window_size & (window_size - 1):
        raise ValueError("window_size must be a power of 2")
    hop = int(window_size * (1 - overlap))
    sig = signal.reshape(-1)
    window = torch.exp(torch.arange(window_size, device=sig.device, dtype=torch.float32)
                       * -0.001)
    if sig.numel() < window_size:  # no whole frame
        return sig.new_zeros((window_size // 2 + 1, 0),
                             dtype=torch.promote_types(sig.dtype, window.dtype))
    frames = sig.unfold(0, window_size, hop) * window
    fft = torch.fft.rfft(frames, dim=-1)
    absolute = torch.sqrt(fft.real.square() + fft.imag.square())
    return absolute.T / 180.0


def _kaiser_sinc_filter(num_taps: int, cutoff: float, beta: float = 8.0) -> np.ndarray:
    """Windowed-sinc low-pass prototype, normalized to unit DC gain (float32)."""
    n = np.arange(num_taps) - (num_taps - 1) / 2
    h = np.sinc(2 * cutoff * n) * 2 * cutoff
    h *= np.kaiser(num_taps, beta)
    return (h / h.sum()).astype(np.float32)


def _phase_weights(up: int, down: int, taps_per_phase: int) -> np.ndarray:
    """The (taps_per_phase, up) float32 polyphase weights of the reduced
    rate up / down: row t, column r is tap t of phase r (the outputs m with
    m mod up = r), the filter h reversed at j0(r) + t * up, j0(r) = (pad - r
    * down) mod up and pad = taps_per_phase * up // 2 (see
    :func:`resample_poly`)."""
    num_taps = taps_per_phase * up
    h = _kaiser_sinc_filter(num_taps, 0.5 / max(up, down)) * np.float32(up)
    reversed_h = h[::-1]
    j0 = (num_taps // 2 - np.arange(up) * down) % up
    return np.stack([reversed_h[j0 + t * up] for t in range(taps_per_phase)])


TILE_BYTES = 48 * 1024  # the input a block of csrc/resample.cu stages in shared memory, at most


def resample_geometry(up: int, down: int, taps_per_phase: int = 16) -> tuple[int, int]:
    """(threads, outputs) of a block of the kernel of ``csrc/resample.cu``
    for the reduced rate up / down.  The threads are a multiple of up where
    up <= 1024 (about 256; else 256), so that a thread's outputs, that many
    apart, share one phase and its weights.  The outputs are the threads
    times about 1024 / threads, halved while their input span,
    ceil((outputs - 1) * down / up) + taps_per_phase samples, would not fit
    ``TILE_BYTES`` with 16-byte alignment (``ValueError`` where one output's
    taps do not)."""
    threads = up * max(1, 256 // up) if up <= 1024 else 256
    outputs = threads * max(1, 1024 // threads)

    def tile_bytes(outputs: int) -> int:
        span = -(-(outputs - 1) * down // up) + taps_per_phase
        return (span + 6) // 4 * 16

    while outputs > 1 and tile_bytes(outputs) > TILE_BYTES:
        outputs //= 2
    if tile_bytes(outputs) > TILE_BYTES:
        raise ValueError(f"{taps_per_phase} taps a phase do not fit the kernel's shared tile")
    return threads, outputs


def resample_taps(m, up: int, down: int, taps_per_phase: int = 16, block: int | None = None):
    """Output m's first tap and phase, as the kernel of ``csrc/resample.cu``
    computes them: (the input sample under tap 0, r = m mod up), for the
    reduced rate up / down; tap t of output m reads input first + t with
    weight ``_phase_weights(...)[t, r]``.  first is ceil((m * down - pad) /
    up), pad = taps_per_phase * up // 2: the plain path's table entry
    start(r) + q * down for m = q * up + r.  The kernel takes it in two
    steps, as here: in 64 bits at the first output m0 of its block of
    ``block`` outputs (by default the kernel's, :func:`resample_geometry`),
    then 32-bit offsets from there.  m: an int or an integer numpy array."""
    block = block or resample_geometry(up, down, taps_per_phase)[1]
    pad = taps_per_phase * up // 2
    m0 = m // block * block
    a0 = m0 * down - pad
    first0 = -(-a0 // up)
    j0 = first0 * up - a0  # in [0, up)
    i = m - m0
    return first0 + (i * down + up - 1 - j0) // up, (m0 % up + i) % up


@functools.cache
def _phase_weights_on(up: int, down: int, taps_per_phase: int,
                      device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_phase_weights(up, down, taps_per_phase), device=device)


def resample(x: torch.Tensor, up: int, down: int, taps_per_phase: int = 16) -> torch.Tensor:
    """The resampler's kernel (``csrc/resample.cu``) on a CUDA tensor: (...,
    N) float32, contiguous -> (..., ceil(N * up / down)) float32, bit for bit
    :func:`resample_poly_plain` on the card, with up and down coprime (not
    both 1).  It replaces no TPU kernel (the JAX package's resampler is an
    XLA convolution); the note in the source says why it was added, what
    bounds it and how it is built.  Raises ``ValueError`` for another
    device, dtype or layout, or rates beyond the kernel's 32-bit block
    arithmetic.  Counts its launches in ``.launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"the resampler's kernel runs on CUDA tensors, not {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"the resampler's kernel takes float32 samples, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the resampler's kernel takes contiguous samples")
    if math.gcd(up, down) != 1 or up == down or up >= 1 << 21 or down >= 1 << 21 \
            or taps_per_phase < 1 or taps_per_phase * up >= 1 << 31:
        raise ValueError(f"the resampler's kernel takes coprime rates under 2^21, got "
                         f"{up} / {down} with {taps_per_phase} taps a phase")
    *lead, n = x.shape
    out_len = -(-n * up // down)
    y = torch.empty((*lead, out_len), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    threads, outputs = resample_geometry(up, down, taps_per_phase)
    w = _phase_weights_on(up, down, taps_per_phase, x.device)
    with torch.cuda.device(x.device):
        code = cuda_build.library().a2m_resample(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), x.numel() // n, n, out_len, up, down,
            taps_per_phase, taps_per_phase * up // 2, threads, outputs,
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(code, "resample")
    resample.launches += 1
    return y


resample.launches = 0
KERNELS = (resample,)


def resample_poly(x: torch.Tensor, up: int, down: int, taps_per_phase: int = 16) -> torch.Tensor:
    """Rational-rate polyphase resampler, the JAX package's filter and edges.

    x: (..., N) -> (..., ceil(N * up / down)) in x's dtype, computed in fp32.
    With g = gcd(up, down), up /= g, down /= g and L = taps_per_phase * up
    taps h (a Kaiser-windowed sinc, beta 8, cutoff 0.5 / max(up, down) of the
    upsampled rate, gain ``up``): output m is the correlation of h reversed
    with the zero-stuffed signal (x[i] at position i * up) padded by L // 2
    zeros in front, read at m * down.  Only the taps on a stuffed sample
    count, ``taps_per_phase`` of them, so output m is a sum of that many
    products (:func:`resample_taps`).  Not scipy's ``resample_poly``
    (another filter and edge layout); the host decoder uses scipy's, as the
    JAX package's does.

    A CUDA tensor goes to the kernel (:func:`resample`: float32 and
    contiguous, else ``ValueError``); any other to
    :func:`resample_poly_plain`.  Span ``frontend.resample`` (``samples``
    out per channel; ``kernel``, its launches, on the card)."""
    with span("frontend.resample") as s:
        g = math.gcd(up, down)
        up, down = up // g, down // g
        if up == 1 and down == 1:
            return x
        if x.device.type == "cuda":
            y = resample(x, up, down, taps_per_phase)
            s.add("samples", y.shape[-1])
            s.add("kernel", 1)
            return y
        y = resample_poly_plain(x, up, down, taps_per_phase)
        s.add("samples", y.shape[-1])
        return y


def resample_poly_plain(x: torch.Tensor, up: int, down: int,
                        taps_per_phase: int = 16) -> torch.Tensor:
    """Plain version of :func:`resample`, on any device and dtype, for
    coprime up and down: the products taken tap by tap over all outputs at
    once, from a (ceil(out / up), up) table of each output's first input
    index built with numpy and copied to x's device (span
    ``frontend.resample_table``, its ``bytes``), so that the zero-stuffed
    signal (``up`` times the input) is never formed."""
    num_taps = taps_per_phase * up
    pad = num_taps // 2
    *lead, n = x.shape
    out_len = math.ceil(n * up / down)
    # Output m = q * up + r: its first tap on a stuffed sample is j0(r) =
    # (pad - r * down) mod up, on input sample start(r) + q * down.
    r = np.arange(up)
    j0 = (pad - r * down) % up
    start = (r * down + j0 - pad) // up  # exact: the numerator is a multiple of up
    q_len = -(-out_len // up)
    weights = _phase_weights(up, down, taps_per_phase)  # (taps, up)
    lo = max(0, -int(start.min()))
    hi = max(0, int(start.max()) + (q_len - 1) * down + taps_per_phase - n)
    xf = F.pad(x.reshape(-1, n).float(), (lo, hi))
    with span("frontend.resample_table") as table:
        first = torch.as_tensor(
            (lo + start)[None, :] + down * np.arange(q_len)[:, None], device=x.device
        )  # (q_len, up): the input index of each output's first tap
        table.add("bytes", first.nbytes)
    w = torch.as_tensor(weights, device=x.device)
    y = xf[:, first] * w[0]
    for t in range(1, taps_per_phase):
        y = y + xf[:, first + t] * w[t]
    return y.reshape(y.shape[0], -1)[:, :out_len].reshape(*lead, out_len).to(x.dtype)


def prepare_windows(samples: torch.Tensor, src_rate: int, dst_rate: int, window_size: int,
                    overlap_samples: int) -> torch.Tensor:
    """Resample to ``dst_rate`` -> loudness normalization -> overlapping
    model windows, all on the samples' device.  (2, N) -> (W, 2,
    window_size) float32.  Spans: ``frontend.resample`` (output samples per
    channel; on the card ``kernel``, the one launch; elsewhere its child
    ``frontend.resample_table``, the bytes of the index table built on the
    host and copied), ``frontend.windows`` (windows)."""
    x = samples.float().contiguous()  # the resampler's kernel takes contiguous samples
    if src_rate != dst_rate:
        x = resample_poly(x, dst_rate, src_rate)
    with span("frontend.windows") as s:
        windows = make_windows(normalize_loudness(x), window_size, overlap_samples)
        s.add("windows", windows.shape[0])
    return windows
