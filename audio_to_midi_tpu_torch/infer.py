"""Inference: windowed prediction, crossfade stitching, file transcription.

Counterpart of the serving half of ``audio_to_midi_tpu/infer.py``.  The model
arrives with its parameters already converted (``load_params`` reads a port
checkpoint: a flat ``.npz`` in the JAX layout, or a ``.pt`` state_dict).

f32 is the checkpoint-parity mode (the JAX package traces it at 'highest'
matmul precision).  On CUDA that means TF32 off for both the matmuls and
cuDNN, since the depthwise convolution runs through cuDNN;
:func:`_parity_precision` sets both for the duration of a call.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np
import torch

from .config import Config
from .convert import jax_to_state_dict, load_npz
from .data.audio_io import load_full_audio_f16
from .models import model as model_lib
from .models.rope import RopeFreqs
from .ops.eventize import extract_events
from .ops.frontend import make_windows
from .ops.stitch import stitch_probs_parallel


@contextlib.contextmanager
def _parity_precision(dtype: torch.dtype):
    """TF32 off for f32 (matmuls and cuDNN), restored afterwards."""
    if dtype != torch.float32:
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _param_dtype(model: torch.nn.Module) -> torch.dtype:
    return next(model.parameters()).dtype


def load_params(
    path: str | Path, cfg: Config, device: torch.device | str,
    dtype: torch.dtype = torch.float32,
) -> model_lib.Model:
    """A port checkpoint -> ``Model`` on ``device`` in ``dtype``.

    ``.npz``: the flat JAX parameter layout (``convert.save_npz``, or
    ``tools/export_params_npz.py`` from a JAX checkpoint).  ``.pt``: the
    port's state_dict (``torch.save(model.state_dict())``)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no checkpoint file at {path}")
    if path.suffix == ".npz":
        state = jax_to_state_dict(load_npz(path))
    elif path.suffix == ".pt":
        state = torch.load(path, map_location="cpu", weights_only=True)
    else:
        raise ValueError(f"{path}: expected a .npz or .pt checkpoint")
    model = model_lib.Model(cfg.model)
    model.load_state_dict(state, strict=True)
    return model.to(device=device, dtype=dtype).eval()


@torch.inference_mode()
def _predict_windows(model, cfg: Config, windows: torch.Tensor, rope: RopeFreqs) -> torch.Tensor:
    _logits, probs = model_lib.forward(model, cfg.model, windows, rope)
    return probs


def predict_and_stitch(
    model: model_lib.Model,
    cfg: Config,
    samples: np.ndarray | torch.Tensor,
    window_duration: float,
    overlap: float = 0.0,
    rope: RopeFreqs | None = None,
):
    """(W, 2, N) windows -> (per-window probs, stitched probs, dpf), numpy."""
    device = next(model.parameters()).device
    dtype = _param_dtype(model)
    rope = rope if rope is not None else model_lib.make_rope(cfg.model, device)
    windows = torch.as_tensor(samples).to(device=device, dtype=dtype)
    with _parity_precision(dtype):
        probs = _predict_windows(model, cfg, windows, rope).float()
    duration_per_frame = window_duration / probs.shape[1]
    stitched = stitch_probs_parallel(probs, overlap, duration_per_frame)
    return probs.cpu().numpy(), stitched.cpu().numpy(), duration_per_frame


def transcribe_file(
    model: model_lib.Model,
    cfg: Config,
    input_file: str | Path,
    overlap: float = 0.5,
    rope: RopeFreqs | None = None,
    max_windows_per_batch: int = 128,
):
    """File -> (stitched probs (frames, 90) float32 numpy, duration_per_frame,
    events).

    The audio is decoded on the host and moves to the model's device once,
    as f16 (the reference's decode dtype); windowing, the model and the
    crossfade stitch run there, in the model's dtype.  Up to
    ``max_windows_per_batch`` windows run as one batch; longer files run in
    chunks of that size, the last one zero-padded.  The eventizer runs on
    the host copy of the stitched probabilities.
    """
    device = next(model.parameters()).device
    dtype = _param_dtype(model)
    window_duration = cfg.data.model_audio_length
    raw = torch.from_numpy(load_full_audio_f16(input_file, cfg.data.sample_rate))
    window_size = round(window_duration * cfg.data.sample_rate)
    overlap_samples = round(overlap * cfg.data.sample_rate)
    windows = make_windows(raw.to(device), window_size, overlap_samples).to(dtype)
    rope = rope if rope is not None else model_lib.make_rope(cfg.model, device)
    num_windows = windows.shape[0]

    chunks = []
    with _parity_precision(dtype):
        if num_windows <= max_windows_per_batch:
            chunks.append(_predict_windows(model, cfg, windows, rope).float())
        else:
            for lo in range(0, num_windows, max_windows_per_batch):
                chunk = windows[lo : lo + max_windows_per_batch]
                take = chunk.shape[0]
                if take < max_windows_per_batch:  # pad to the common batch shape
                    pad = chunk.new_zeros((max_windows_per_batch - take, *chunk.shape[1:]))
                    chunk = torch.cat([chunk, pad])
                chunks.append(_predict_windows(model, cfg, chunk, rope)[:take].float())
    all_probs = torch.cat(chunks)
    # Reuse the rounded window_size from above: int() truncation could land
    # one sample short and yield a different frame count than the windows the
    # model actually saw, skewing every MIDI timestamp by one frame's worth.
    duration_per_frame = window_duration / cfg.model.output_frames(window_size)
    stitched = stitch_probs_parallel(
        all_probs, overlap, window_duration / all_probs.shape[1]
    ).cpu().numpy()
    return stitched, duration_per_frame, extract_events(stitched)
