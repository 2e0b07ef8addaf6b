"""Audio frontend on tensors: resampling, loudness normalization and window
slicing.

Counterpart of ``make_windows``, ``slice_full_audio``, ``normalize_loudness``,
``resample_poly``, ``prepare_windows`` and ``fft_audio`` in
``audio_to_midi_tpu/ops/frontend.py``.  They run on whatever device the
samples lie on.  ``split_training_windows`` is the numpy host helper of the
same file.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


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


def resample_poly(x: torch.Tensor, up: int, down: int, taps_per_phase: int = 16) -> torch.Tensor:
    """Rational-rate polyphase resampler, the JAX package's filter and edges.

    x: (..., N) -> (..., ceil(N * up / down)) in x's dtype, computed in fp32.
    With g = gcd(up, down), up /= g, down /= g and L = taps_per_phase * up
    taps h (a Kaiser-windowed sinc, beta 8, cutoff 0.5 / max(up, down) of the
    upsampled rate, gain ``up``): output m is the correlation of h reversed
    with the zero-stuffed signal (x[i] at position i * up) padded by L // 2
    zeros in front, read at m * down.  Only the taps on a stuffed sample
    count, ``taps_per_phase`` of them, so output m is a sum of that many
    products, taken tap by tap over all outputs at once: the zero-stuffed
    signal (``up`` times the input) is never formed.  Not scipy's
    ``resample_poly`` (another filter and edge layout); the host decoder
    uses scipy's, as the JAX package's does.
    """
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x
    num_taps = taps_per_phase * up
    h = _kaiser_sinc_filter(num_taps, 0.5 / max(up, down)) * np.float32(up)
    reversed_h = h[::-1]
    pad = num_taps // 2
    *lead, n = x.shape
    out_len = math.ceil(n * up / down)
    # Output m = q * up + r: its first tap on a stuffed sample is j0(r) =
    # (pad - r * down) mod up, on input sample start(r) + q * down.
    r = np.arange(up)
    j0 = (pad - r * down) % up
    start = (r * down + j0 - pad) // up  # exact: the numerator is a multiple of up
    q_len = -(-out_len // up)
    weights = np.stack([reversed_h[j0 + t * up] for t in range(taps_per_phase)])  # (taps, up)
    lo = max(0, -int(start.min()))
    hi = max(0, int(start.max()) + (q_len - 1) * down + taps_per_phase - n)
    xf = F.pad(x.reshape(-1, n).float(), (lo, hi))
    first = torch.as_tensor(
        (lo + start)[None, :] + down * np.arange(q_len)[:, None], device=x.device
    )  # (q_len, up): the input index of each output's first tap
    w = torch.as_tensor(weights, device=x.device)
    y = xf[:, first] * w[0]
    for t in range(1, taps_per_phase):
        y = y + xf[:, first + t] * w[t]
    return y.reshape(y.shape[0], -1)[:, :out_len].reshape(*lead, out_len).to(x.dtype)


def prepare_windows(samples: torch.Tensor, src_rate: int, dst_rate: int, window_size: int,
                    overlap_samples: int) -> torch.Tensor:
    """Resample to ``dst_rate`` -> loudness normalization -> overlapping
    model windows, all on the samples' device.  (2, N) -> (W, 2,
    window_size) float32."""
    x = samples.float()
    if src_rate != dst_rate:
        x = resample_poly(x, dst_rate, src_rate)
    x = normalize_loudness(x)
    return make_windows(x, window_size, overlap_samples)
