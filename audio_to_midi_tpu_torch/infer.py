"""Inference: windowed prediction, crossfade stitching, file transcription.

Counterpart of the serving half of ``audio_to_midi_tpu/infer.py``.  The model
arrives with its parameters already converted (``load_params`` reads a port
checkpoint: a flat ``.npz`` in the JAX layout, or a ``.pt`` state_dict).

f32 is the checkpoint-parity mode (the JAX package traces it at 'highest'
matmul precision).  On CUDA that means TF32 off for both the matmuls and
cuDNN, since the depthwise convolution runs through cuDNN;
:func:`_parity_precision` sets both for the duration of a call.

Everything after the decode runs on the model's device: windowing, the
model, the crossfade stitch and the eventizer, so a model on the card
eventizes on the card and only the event table comes back.  With a
``mesh`` of several data ranks (``parallel.make_mesh``) one file is
transcribed across them: the window batches are split over ``"data"``, the
probabilities gathered, and every rank stitches and eventizes the same
array.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import math
import time
from pathlib import Path

import numpy as np
import torch

from .config import DTYPES, Config, ModelConfig
from .convert import jax_to_state_dict, load_npz
from .data.audio_io import load_full_audio_f16
from .models import model as model_lib
from .models.rope import RopeFreqs
from .ops.eventize import extract_events
from .ops.frontend import make_windows, prepare_windows
from .ops.stitch import stitch_chunk, stitch_chunk_plan, stitch_probs_parallel
from .parallel.mesh import DATA_AXIS, Mesh
from .utils.profiling import recording, span

log = logging.getLogger(__name__)


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


def _param(model: torch.nn.Module) -> torch.Tensor:
    return next(model.parameters())


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


def load_newest_checkpoint(
    checkpoint_path: str | Path, cfg: Config, device: torch.device | str,
    dtype: torch.dtype = torch.float32, step: int | None = None, *,
    ensemble_size: int = 1, ensemble_select: int | None = 0,
) -> tuple[model_lib.Model | model_lib.Ensemble, dict]:
    """The latest checkpoint of a training directory (``train/checkpoint.py``)
    -> (model on ``device`` in ``dtype``, state), as the JAX package's
    ``load_newest_checkpoint``; warns when the stored metadata differs from
    ``cfg``'s.  A checkpoint of a population needs its ``ensemble_size``;
    ``ensemble_select`` picks one member's ``Model`` off it, and None keeps
    the whole ``Ensemble``."""
    from .train import checkpoint as ckpt

    manager = ckpt.create_checkpoint_manager(checkpoint_path, cfg)
    ckpt.check_metadata(manager, cfg)
    if ensemble_size == 1:
        if ensemble_select not in (0, None):
            raise ValueError(f"ensemble_select={ensemble_select} of a single model")
        model = model_lib.Model(cfg.model)
    else:
        model = model_lib.Ensemble(model_lib.Model(cfg.model) for _ in range(ensemble_size))
    restored = ckpt.restore_checkpoint(manager, model, {}, step=step)
    if restored is None:
        raise FileNotFoundError(f"There is no checkpoint to load in {checkpoint_path}!")
    model, state, restored_step = restored
    log.info("Restored checkpoint at step %d", restored_step)
    if ensemble_size > 1 and ensemble_select is not None:
        model = model[ensemble_select]
    return model.to(device=device, dtype=dtype).eval(), state


@torch.inference_mode()
def _predict_windows(model, cfg: ModelConfig, windows: torch.Tensor,
                     rope: RopeFreqs) -> torch.Tensor:
    _logits, probs = model_lib.forward(model, cfg, windows, rope)
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
    param = _param(model)
    rope = rope if rope is not None else model_lib.make_rope(cfg.model, param.device)
    windows = torch.as_tensor(samples).to(device=param.device, dtype=param.dtype)
    with _parity_precision(param.dtype):
        probs = _predict_windows(model, cfg.model, windows, rope).float()
    duration_per_frame = window_duration / probs.shape[1]
    stitched = stitch_probs_parallel(probs, overlap, duration_per_frame)
    return probs.cpu().numpy(), stitched.cpu().numpy(), duration_per_frame


def predict_and_stitch_fused(
    model: model_lib.Model, cfg: ModelConfig, windows: torch.Tensor, rope: RopeFreqs,
    window_duration: float, overlap: float, valid_windows: int | None = None,
) -> torch.Tensor:
    """The model forward on (W, 2, N) windows, then the crossfade stitch:
    (frames, 90) float32 on the windows' device.  ``valid_windows``: where
    the batch is padded, only its first ``valid_windows`` windows stitch.
    The windows are cast to the model's dtype.  Spans: ``model.forward``
    (windows), then ``ops.stitch``."""
    dtype = _param(model).dtype
    with span("model.forward") as s:
        s.add("windows", windows.shape[0])
        with _parity_precision(dtype):
            probs = _predict_windows(model, cfg, windows.to(dtype), rope).float()
        if valid_windows is not None and valid_windows < probs.shape[0]:
            probs = probs[:valid_windows]
    return stitch_probs_parallel(probs, overlap, window_duration / probs.shape[1])


def transcribe_samples_fused(
    model: model_lib.Model, cfg: Config, samples: np.ndarray | torch.Tensor,
    rope: RopeFreqs, src_rate: int, window_duration: float, overlap: float,
) -> torch.Tensor:
    """Raw in-memory audio (2, N) at ``src_rate`` -> stitched probabilities
    (frames, 90) float32, on the model's device: resample (the JAX package's
    polyphase filter, ``ops/frontend.resample_poly``) -> loudness
    normalization -> windows -> model -> crossfade stitch.  The model and
    the windows run in ``cfg.precision.compute_dtype``; where that is not
    the model's dtype a cast copy of the model runs, and ``model`` stays as
    it is.

    Span ``serve.transcribe`` (audio samples in, per channel) over
    ``frontend.h2d`` (bytes), the frontend's spans, ``serve.cast_model``
    (leaves and bytes cast; only where the dtypes differ), ``model.forward``
    and ``ops.stitch``."""
    with span("serve.transcribe") as root:
        root.add("samples", samples.shape[-1])
        param = _param(model)
        dst_rate = cfg.data.sample_rate
        window_size = round(window_duration * dst_rate)
        overlap_samples = round(overlap * dst_rate)
        with span("frontend.h2d") as s:
            audio = torch.as_tensor(samples)
            s.add("bytes", audio.nbytes)
            audio = audio.to(param.device)
        windows = prepare_windows(audio, src_rate, dst_rate, window_size, overlap_samples)
        del audio   # the recording on the device: free before the forward
        compute = DTYPES[cfg.precision.compute_dtype]
        if param.dtype != compute:
            with span("serve.cast_model") as s:
                model = model_lib.cast_params(copy.deepcopy(model), compute)
                if s.on:
                    leaves = [*model.parameters(), *model.buffers()]
                    s.add("leaves", len(leaves))
                    s.add("bytes", sum(t.nbytes for t in leaves))
        return predict_and_stitch_fused(model, cfg.model, windows, rope, window_duration,
                                        overlap)


def _predict_sharded(model, cfg: ModelConfig, windows: torch.Tensor, rope: RopeFreqs,
                     mesh: Mesh) -> torch.Tensor:
    """This rank's ``"data"`` share of the windows (a whole multiple of the
    data extent) through the model, the f32 probabilities gathered over
    ``"data"`` in window order."""
    n = mesh.extent(DATA_AXIS)
    per = windows.shape[0] // n
    lo = mesh.index(DATA_AXIS) * per
    local = _predict_windows(model, cfg, windows[lo: lo + per], rope).float()
    return mesh.all_gather(local, DATA_AXIS).flatten(0, 1)


@contextlib.contextmanager
def _stage(times: dict | None, name: str, device: torch.device):
    """Span ``file.<name>``; with ``times``, it ends by synchronizing the
    device, so that it holds its own work, and its seconds go into
    ``times[name]``."""
    with span("file." + name) as s:
        yield
        if times is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
    if times is not None:
        times[name] = times.get(name, 0.0) + s.ns / 1e9


def transcribe_file(
    model: model_lib.Model,
    cfg: Config,
    input_file: str | Path,
    overlap: float = 0.5,
    rope: RopeFreqs | None = None,
    max_windows_per_batch: int = 128,
    stage_times: dict | None = None,
    fetch_stitched: bool = True,
    mesh: Mesh | None = None,
):
    """File -> (stitched probs (frames, 90) float32 numpy, duration_per_frame,
    events).

    The audio is decoded on the host and moves to the model's device once,
    as f16 (the reference's decode dtype); windowing, the model, the
    crossfade stitch and the eventizer run there, the model in its dtype.
    Up to ``max_windows_per_batch`` windows run as one batch; longer files
    run in chunks of that size, the last one zero-padded.  Only the event
    table, and the stitched probabilities unless ``fetch_stitched`` is False
    (then None is returned in their place), come back to the host.

    ``stage_times``: a dict that receives the seconds of each stage
    (decode, transfer, window, model_stitch, eventize, fetch), read from
    the spans ``file.<stage>`` under ``file.transcribe``, which are then on
    (``utils/profiling.recording``).  Each stage then ends by synchronizing
    the device, so the stages do not overlap; without it nothing
    synchronizes but the fetches.

    ``mesh``: with more than one rank along ``"data"`` (every rank calls,
    with the same model), the chunk size is rounded to the data extent,
    each chunk is zero-padded to whole shards, and each rank runs its share
    of every chunk; every rank returns the same stitched array and events.
    """
    on = recording() if stage_times is not None else contextlib.nullcontext()
    with on, span("file.transcribe"):
        param = _param(model)
        device, dtype = param.device, param.dtype
        window_duration = cfg.data.model_audio_length
        with _stage(stage_times, "decode", device):
            raw = torch.from_numpy(load_full_audio_f16(input_file, cfg.data.sample_rate))
        with _stage(stage_times, "transfer", device):
            raw = raw.to(device)
        with _stage(stage_times, "window", device):
            window_size = round(window_duration * cfg.data.sample_rate)
            overlap_samples = round(overlap * cfg.data.sample_rate)
            windows = make_windows(raw, window_size, overlap_samples).to(dtype)
        with _stage(stage_times, "model_stitch", device):
            stitched = _model_stitch(model, cfg, windows, rope, overlap, max_windows_per_batch,
                                     mesh)
        # Reuse the rounded window_size from above: int() truncation could land
        # one sample short and yield a different frame count than the windows the
        # model actually saw, skewing every MIDI timestamp by one frame's worth.
        duration_per_frame = window_duration / cfg.model.output_frames(window_size)
        with _stage(stage_times, "eventize", device):
            events = extract_events(stitched)
        with _stage(stage_times, "fetch", device):
            stitched_np = stitched.cpu().numpy() if fetch_stitched else None
        return stitched_np, duration_per_frame, events


def _model_stitch(model, cfg: Config, windows: torch.Tensor, rope: RopeFreqs | None,
                  overlap: float, max_windows_per_batch: int, mesh: Mesh | None) -> torch.Tensor:
    """:func:`transcribe_file`'s windows through the model, in chunks of up
    to ``max_windows_per_batch`` (over the mesh's ``"data"`` ranks where it
    has several), then stitched."""
    param = _param(model)
    device, dtype = param.device, param.dtype
    window_duration = cfg.data.model_audio_length
    rope = rope if rope is not None else model_lib.make_rope(cfg.model, device)
    num_windows = windows.shape[0]
    data = 1 if mesh is None else mesh.extent(DATA_AXIS)

    if data > 1:
        # Chunks split over "data": the chunk size rounded to the mesh, each
        # chunk padded to whole shards.
        max_windows_per_batch = max(data, max_windows_per_batch // data * data)
        chunks = []
        with _parity_precision(dtype):
            for lo in range(0, num_windows, max_windows_per_batch):
                chunk = windows[lo: lo + max_windows_per_batch]
                take = chunk.shape[0]
                pad = (-take) % data if num_windows <= max_windows_per_batch else (
                    max_windows_per_batch - take)
                if pad:
                    chunk = torch.cat([chunk, chunk.new_zeros((pad, *chunk.shape[1:]))])
                chunks.append(_predict_sharded(model, cfg.model, chunk, rope, mesh)[:take])
    elif num_windows <= max_windows_per_batch:
        return predict_and_stitch_fused(model, cfg.model, windows, rope, window_duration,
                                        overlap, valid_windows=num_windows)
    else:
        chunks = []
        with _parity_precision(dtype):
            for lo in range(0, num_windows, max_windows_per_batch):
                chunk = windows[lo : lo + max_windows_per_batch]
                take = chunk.shape[0]
                if take < max_windows_per_batch:  # pad to the common batch shape
                    pad = chunk.new_zeros((max_windows_per_batch - take, *chunk.shape[1:]))
                    chunk = torch.cat([chunk, pad])
                chunks.append(_predict_windows(model, cfg.model, chunk, rope)[:take].float())
    all_probs = torch.cat(chunks)
    return stitch_probs_parallel(all_probs, overlap, window_duration / all_probs.shape[1])


# Frames an event's release must lie inside the emitted prefix to be final:
# the 10-frame peak lookahead and the 6-frame re-activation average
# (common.rs:47-144), as the JAX package counts them.
_FINAL_MARGIN = 16


def transcribe_file_streaming(
    model: model_lib.Model,
    cfg: Config,
    input_file: str | Path,
    overlap: float = 0.5,
    rope: RopeFreqs | None = None,
    chunk_windows: int = 32,
    stage_times: dict | None = None,
    fetch_stitched: bool = True,
    on_segment=None,
):
    """Chunked (streaming) transcription: decode once, then copy / infer /
    stitch chunks of ``chunk_windows`` windows.  On the card the copy of
    chunk k + 1 (from pinned host memory, on a side stream) overlaps the
    model on chunk k, the device memory the model takes is bounded by one
    chunk whatever the file's length, and the first stitched rows are ready
    after one chunk.  Returns (stitched, duration_per_frame, events) as
    :func:`transcribe_file`.

    Windows are cut at the same global sample offsets as the batch path (the
    last chunk zero-padded to a whole chunk, its first windows kept), and
    the chunks stitch by the global plan with one context window each
    (``ops/stitch.stitch_chunk``), which gives the batch stitcher's rows bit
    for bit.  The model runs at ``chunk_windows`` windows where the batch
    path runs up to 128: on the CPU the outputs agree to a few f32 ulps; on
    the card cuBLAS and cuDNN may take other algorithms at another batch, so
    the stitched probabilities agree within the correctness gate (1e-4 in
    f32) and the events are identical unless a probability lies within that
    of an eventizer threshold.  Where the overlap breaks the pairwise-blend
    precondition (``stitch_chunk_plan`` raises ``ValueError``) this runs
    :func:`transcribe_file`, as the JAX package does.

    ``on_segment(w0, seg)``: called with each chunk's stitched rows (on the
    device) and its first window's index.  ``stage_times`` receives
    ``decode``, ``first_segment_s`` and ``first_event_s`` (seconds from the
    start until the first stitched rows, and the first final event -- one
    whose release lies 16 frames inside them -- are known; None if there is
    none in the first chunk) and ``total_s``.
    """
    t_start = time.perf_counter()
    param = _param(model)
    device, dtype = param.device, param.dtype
    window_duration = cfg.data.model_audio_length
    sample_rate = cfg.data.sample_rate
    window_size = round(window_duration * sample_rate)
    overlap_samples = round(overlap * sample_rate)
    step = window_size - overlap_samples
    fpw = cfg.model.output_frames(window_size)
    duration_per_frame = window_duration / fpw

    raw = load_full_audio_f16(input_file, sample_rate)  # (2, N) f16 on the host
    if stage_times is not None:
        stage_times["decode"] = time.perf_counter() - t_start
    n = raw.shape[1]
    n_windows = max(1, math.ceil((n - overlap_samples) / step))
    try:
        d_all, own_all, output_frames, ov = stitch_chunk_plan(
            n_windows, fpw, overlap, duration_per_frame)
    except ValueError:
        log.info("streaming stitch unavailable for overlap %s; using batch path", overlap)
        return transcribe_file(model, cfg, input_file, overlap=overlap, rope=rope,
                               stage_times=stage_times, fetch_stitched=fetch_stitched)

    rope = rope if rope is not None else model_lib.make_rope(cfg.model, device)
    chunk_len = (chunk_windows - 1) * step + window_size  # samples per chunk
    on_card = device.type == "cuda"
    copier = torch.cuda.Stream(device) if on_card else None

    def ship(w0: int):
        """Chunk w0's samples on the device (its copy in flight on the side
        stream on the card), its window count, and the host buffer, held
        until the copy is consumed."""
        lo = w0 * step
        host = torch.zeros((2, chunk_len), dtype=torch.float16, pin_memory=on_card)
        part = raw[:, lo : lo + chunk_len]
        host[:, : part.shape[1]] = torch.from_numpy(part)  # the last chunk: zero-padded
        wc = min(chunk_windows, n_windows - w0)
        if not on_card:
            return host, wc, None, host
        with torch.cuda.stream(copier):
            dev = host.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copier)
        return dev, wc, done, host

    segs = []
    prev_window = torch.zeros((fpw, cfg.model.output_vocab), dtype=torch.float32, device=device)
    pending = ship(0)
    first_segment_s = first_event_s = None
    for w0 in range(0, n_windows, chunk_windows):
        chunk, wc, done, _host = pending
        if done is not None:
            torch.cuda.current_stream(device).wait_event(done)
            chunk.record_stream(torch.cuda.current_stream(device))
        if w0 + chunk_windows < n_windows:
            pending = ship(w0 + chunk_windows)  # its copy overlaps this chunk's model
        windows = make_windows(chunk, window_size, overlap_samples).to(dtype)
        with _parity_precision(dtype):
            probs = _predict_windows(model, cfg.model, windows, rope)[:wc].float()
        seg = stitch_chunk(prev_window, probs, d=d_all[w0 : w0 + wc], own=own_all[w0 : w0 + wc],
                           ov=ov, first=w0 == 0)
        prev_window = probs[-1]
        segs.append(seg)
        if on_segment is not None:
            on_segment(w0, seg)
        if stage_times is not None and first_segment_s is None:
            if on_card:
                torch.cuda.synchronize(device)
            first_segment_s = time.perf_counter() - t_start
            if any(a + d + _FINAL_MARGIN <= seg.shape[0] for a, _k, d, _v in extract_events(seg)):
                first_event_s = time.perf_counter() - t_start
    stitched = torch.cat(segs, dim=0)
    if stitched.shape[0] < output_frames:  # the zero tail the batch stitcher leaves
        stitched = torch.cat([stitched, stitched.new_zeros(
            (output_frames - stitched.shape[0], stitched.shape[1]))])
    events = extract_events(stitched)
    if stage_times is not None:
        stage_times["first_segment_s"] = first_segment_s
        stage_times["first_event_s"] = first_event_s
        stage_times["total_s"] = time.perf_counter() - t_start
    stitched_np = stitched.cpu().numpy() if fetch_stitched else None
    return stitched_np, duration_per_frame, events
