"""Host dataset loading: decode -> cache -> label rasterization -> windows ->
batches, with the ``modelutil`` surface of the reference plugin
(python.rs:1007-1020) and a threaded prefetching batch loader.

Counterpart of ``audio_to_midi_tpu/data/loader.py``.  When the native C++
data plane (``native.py``) is built, the decode/cache/rasterize inner loop
and the host augmentation dispatch to it; otherwise the numpy
implementations of this package run.  Either path gives the JAX package's
arrays on the same path.  :func:`create_dataset_loader` builds, as the JAX
one does where grain is installed, the grain pipeline (:class:`GrainLoader`:
the same stream of batches, through ``torch.utils.data`` worker processes,
without grain) or, with ``use_grain=False``, the threaded loader.
"""

from __future__ import annotations

import hashlib
import math
import multiprocessing
import os
import queue
import threading
import time
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch.utils.data

from .. import native
from ..config import (
    MIDI_EVENT_VOCAB_SIZE,
    MODEL_AUDIO_LENGTH,
    SAMPLE_RATE,
    TransformSettings,
)
from ..ops.rasterize import rasterize_events_np
from . import augment
from .audio_io import NATIVE_SUFFIXES, NO_CACHE, decode_audio, load_full_audio_f16
from .audio_io import normalize_loudness_np
from .index_shuffle import index_shuffle_array
from .labels import parse_events_csv

AUDIO_EXTENSIONS = (".wav", ".aif", ".aac", ".aiff")


def _use_native() -> bool:
    """The C++ data plane is preferred when built; A2M_DISABLE_NATIVE=1 or an
    unavailable toolchain falls back to the numpy implementations."""
    return native.available()


# ---------------------------------------------------------------------------
# Sample discovery (reference audio_to_midi_dataset.py:336-353)
# ---------------------------------------------------------------------------


def load_sample_names(dataset_dir: str | Path) -> list[str]:
    dataset_dir = Path(dataset_dir)
    audio_names: set[str] = set()
    for ext in AUDIO_EXTENSIONS:
        for p in dataset_dir.rglob(f"*{ext}"):
            audio_names.add(str(p.relative_to(dataset_dir))[: -len(ext)])
    label_names = {
        str(p.relative_to(dataset_dir))[:-4] for p in dataset_dir.rglob("*.csv")
    }
    if audio_names != label_names:
        raise ValueError(
            "Did not find the same set of labels and samples! "
            f"audio-without-csv={audio_names - label_names}, "
            f"csv-without-audio={label_names - audio_names}"
        )
    return sorted(audio_names)


def resolve_audio_file(sample_path: str | Path) -> Path:
    for ext in AUDIO_EXTENSIONS:
        candidate = Path(str(sample_path) + ext)
        if candidate.exists():
            return candidate
    raise FileNotFoundError(f"Audio not found for sample: {sample_path}")


# ---------------------------------------------------------------------------
# On-disk decoded-sample cache (reference python.rs:282-371)
# ---------------------------------------------------------------------------


def _cache_file(path: str, sample_rate: int) -> Optional[Path]:
    cache_dir = os.environ.get("SAMPLE_CACHE_DIR")
    if not cache_dir:
        return None
    h = hashlib.sha256(path.encode()).hexdigest()[:30]
    name = f"{h}_{sample_rate}"
    return Path(cache_dir) / name[:4] / f"{name}.npy"


def load_audio_sample(
    path: str | Path, sample_rate: int, skip_cache: bool = False
) -> np.ndarray:
    """Decode + normalize with f16 on-disk caching.  (2, N) float32."""
    path = str(path)
    if _use_native() and Path(path).suffix.lower() in NATIVE_SUFFIXES:
        return native.load_audio_sample(path, sample_rate, skip_cache)
    cache = _cache_file(path, sample_rate)
    if cache is not None and cache.exists() and not skip_cache:
        try:
            return np.load(cache).astype(np.float32)
        except Exception:
            cache.unlink(missing_ok=True)  # self-heal corrupt entries

    samples = normalize_loudness_np(decode_audio(path, sample_rate))
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        tmp = cache.with_suffix(".tmp.npy")
        np.save(tmp, samples.astype(np.float16))
        tmp.replace(cache)
    # The reference's decode always returns f16 samples (python.rs:236-264
    # Vec<f16>), cached or not — round-trip to match its values exactly.
    return samples.astype(np.float16).astype(np.float32)


def load_full_audio(file: str | Path, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """modelutil.load_full_audio parity (python.rs:373-394): no cache read;
    values round through f16 as the reference's decode does."""
    if _use_native() and Path(file).suffix.lower() in NATIVE_SUFFIXES:
        return native.load_audio_sample(str(file), sample_rate, NO_CACHE)
    samples = normalize_loudness_np(decode_audio(str(file), sample_rate))
    return samples.astype(np.float16).astype(np.float32)


# ---------------------------------------------------------------------------
# Batch loading: windows + rasterized labels (reference python.rs:455-564)
# ---------------------------------------------------------------------------


# In-memory per-sample window memo: the windowing + label rasterization of a
# sample is deterministic given (rate, duration, frames), and on a few-core
# host redoing it every batch dominates the training feed (TRAINBENCH:
# ~430 ms/step of the loader path was re-windowing already-decoded audio).
# Bytes-capped FIFO; entries are READ-ONLY — every consumer copies (np.stack)
# before mutating.  Thread-safe enough for the loader's daemon workers (dict
# ops are atomic under the GIL; a lost race just recomputes).
_WINDOW_MEMO: dict = {}
_WINDOW_MEMO_BYTES = [0]
_WINDOW_MEMO_BUDGET = int(os.environ.get("A2M_WINDOW_MEMO_BYTES", 2 * 1024**3))


def _window_memo_put(key, value):
    if key in _WINDOW_MEMO:  # concurrent worker computed it first
        return
    nbytes = sum(a.nbytes for a in value[0]) + sum(e.nbytes for e in value[1])
    if nbytes > _WINDOW_MEMO_BUDGET:
        return  # never cached -> caller keeps exclusive, writable arrays
    # Enforce read-only on the shared entries: callers that get memo hits (the
    # public modelutil surface included) receive these same ndarrays, and an
    # in-place mutation must raise rather than silently poison the cache.
    for arr in (*value[0], *value[1]):
        arr.setflags(write=False)
    while _WINDOW_MEMO and _WINDOW_MEMO_BYTES[0] + nbytes > _WINDOW_MEMO_BUDGET:
        try:
            old = _WINDOW_MEMO.pop(next(iter(_WINDOW_MEMO)))
        except (KeyError, RuntimeError):  # racing eviction from another worker
            continue
        _WINDOW_MEMO_BYTES[0] -= sum(a.nbytes for a in old[0]) + sum(
            e.nbytes for e in old[1]
        )
    _WINDOW_MEMO[key] = value
    _WINDOW_MEMO_BYTES[0] += nbytes


def load_events_and_audio(
    dataset_dir: str | Path,
    sample_names: list[str],
    sample_rate: int,
    model_duration: float,
    num_model_outputs: int,
    skip_cache: bool = False,
) -> tuple[list[np.ndarray], list[np.ndarray], list[str]]:
    """Load + window a batch of samples.

    Returns (audio windows [(2, W)], label rasters [(F, 90)], window names
    "name+split"); windows with <=50% real samples are dropped
    (python.rs:517).
    """
    dataset_dir = Path(dataset_dir)
    dpf = model_duration / num_model_outputs
    samples_per_call = int(sample_rate * model_duration)

    all_audio: list[np.ndarray] = []
    all_events: list[np.ndarray] = []
    all_names: list[str] = []
    use_native = _use_native()
    for name in sample_names:
        memo_key = (
            str(dataset_dir), name, sample_rate, model_duration, num_model_outputs
        )
        cached = None if skip_cache else _WINDOW_MEMO.get(memo_key)
        if cached is not None:
            a, e, n_ = cached
            all_audio.extend(a)
            all_events.extend(e)
            all_names.extend(n_)
            continue
        memo_start = len(all_audio)
        audio_path = resolve_audio_file(dataset_dir / name)
        audio = load_audio_sample(audio_path, sample_rate, skip_cache)
        if use_native:
            events = native.parse_events_csv(dataset_dir / f"{name}.csv", dpf)
        else:
            events = parse_events_csv(dataset_dir / f"{name}.csv", dpf)

        n = audio.shape[1]
        num_splits = math.ceil(n / samples_per_call)
        for split in range(num_splits):
            start_frame = split * num_model_outputs
            start_sample = split * samples_per_call
            samples_to_copy = min(samples_per_call, n - start_sample)
            backing = math.ceil(
                samples_to_copy / samples_per_call * num_model_outputs
            )
            if samples_to_copy <= samples_per_call // 2:
                continue
            if use_native:
                frame_events = native.rasterize_events(
                    events, num_model_outputs, start_frame, backing
                )
            else:
                frame_events = rasterize_events_np(
                    events, num_model_outputs, start_frame, backing
                )
            window = np.zeros((2, samples_per_call), np.float32)
            window[:, :samples_to_copy] = audio[:, start_sample : start_sample + samples_to_copy]
            all_audio.append(window)
            all_events.append(frame_events)
            all_names.append(f"{name}+{split}")
        if not skip_cache:
            _window_memo_put(
                memo_key,
                (
                    all_audio[memo_start:],
                    all_events[memo_start:],
                    all_names[memo_start:],
                ),
            )
    return all_audio, all_events, all_names


def load_events_and_audio_with_transformations(
    dataset_dir: str | Path,
    sample_names: list[str],
    sample_rate: int,
    model_duration: float,
    num_model_outputs: int,
    settings: TransformSettings,
    skip_cache: bool = False,
    rng: np.random.Generator | None = None,
) -> tuple[list[np.ndarray], list[np.ndarray], list[str]]:
    audio_list, events_list, names = load_events_and_audio(
        dataset_dir, sample_names, sample_rate, model_duration, num_model_outputs, skip_cache
    )
    if audio_list:
        audio = np.ascontiguousarray(np.stack(audio_list), np.float32)
        labels = np.ascontiguousarray(np.stack(events_list), np.float32)
        if rng is None:
            rng = np.random.default_rng()
        if _use_native():
            native.transform_for_training(
                audio, labels, settings, seed=int(rng.integers(0, 2**63 - 1))
            )
        else:
            augment.transform_for_training(audio, labels, settings, rng)
        audio_list = list(audio)
        events_list = list(labels)
    return audio_list, events_list, names


# ---------------------------------------------------------------------------
# High-level loaders
# ---------------------------------------------------------------------------


def load_samples(
    dataset_dir, num_model_output_frames, samples, sample_rate, audio_duration,
    skip_cache: bool = False,
):
    """AudioToMidiDatasetLoader.load_samples parity: stacked arrays."""
    audio, events, names = load_events_and_audio(
        dataset_dir, samples, sample_rate, audio_duration, num_model_output_frames,
        skip_cache,
    )
    return np.stack(events), np.stack(audio), names


def load_and_slice_full_audio(
    filename,
    overlap: float = 0.25,
    sample_rate: int = SAMPLE_RATE,
    window_duration: float = MODEL_AUDIO_LENGTH,
):
    """Inference windowing (audio_to_midi_dataset.py:277-294): overlap in
    seconds; returns ((W, 2, window), window_duration)."""
    audio = load_full_audio(filename, sample_rate)
    window_size = round(window_duration * sample_rate)
    overlap_samples = round(overlap * sample_rate)
    step = window_size - overlap_samples
    n_windows = max(1, math.ceil((audio.shape[1] - overlap_samples) / step))
    windows = []
    for i in range(n_windows):
        w = audio[:, i * step : i * step + window_size]
        if w.shape[1] < window_size:
            w = np.pad(w, ((0, 0), (0, window_size - w.shape[1])))
        windows.append(w)
    return np.stack(windows), window_duration


class AudioToMidiDatasetLoader:
    """Reference-compatible class surface (audio_to_midi_dataset.py:110-353).

    Classmethods mirror the reference API exactly; iteration is provided by
    :class:`ThreadedBatchLoader` (constructed the same way, minus the
    busy-wait).
    """

    SAMPLE_RATE = SAMPLE_RATE

    def __init__(
        self,
        num_model_output_frames: int,
        dataset_dir,
        batch_size: int,
        prefetch_count: int = 4,
        key=None,
        num_workers: int = 1,
        epochs: int | None = None,
        transform_settings: Optional[TransformSettings] = None,
    ):
        seed = 0xBEEF if key is None else int(np.asarray(key).sum()) & 0x7FFFFFFF
        self._loader = ThreadedBatchLoader(
            dataset_dir,
            batch_size,
            num_model_output_frames,
            transform_settings,
            num_workers=num_workers,
            prefetch=prefetch_count,
            epochs=epochs,
            seed=seed,
        )

    def __iter__(self):
        for events, audio in self._loader:
            yield {"audio": audio, "events": events}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._loader.close()

    @classmethod
    def load_samples(
        cls, dataset_dir, num_model_output_frames, samples, sample_rate,
        audio_duration, skip_cache: bool = False,
    ):
        return load_samples(
            dataset_dir, num_model_output_frames, samples, sample_rate,
            audio_duration, skip_cache,
        )

    @classmethod
    def load_samples_with_transformations(
        cls, dataset_dir, num_model_output_frames, samples, sample_rate,
        audio_duration, transform_settings, skip_cache: bool = False,
    ):
        audio, events, names = load_events_and_audio_with_transformations(
            dataset_dir, samples, sample_rate, audio_duration,
            num_model_output_frames, transform_settings, skip_cache,
        )
        return np.stack(events), np.stack(audio), names

    @classmethod
    def load_and_slice_full_audio(cls, filename, overlap: float = 0.25):
        return load_and_slice_full_audio(filename, overlap)

    @classmethod
    def load_sample_names(cls, dataset_dir):
        return load_sample_names(dataset_dir)


class ThreadedBatchLoader:
    """Lightweight shuffling batch loader with a bounded prefetch queue.

    Equivalent of the reference's AudioToMidiDatasetLoader worker threads
    (audio_to_midi_dataset.py:110-276) without the busy-wait: a proper
    ``queue.Queue`` provides backpressure.  Yields dicts with f16 arrays
    (matching the grain path's dtype, grain_loader.py:88).
    """

    def __init__(
        self,
        dataset_dir: str | Path,
        batch_size: int,
        num_model_output_frames: int,
        transform_settings: Optional[TransformSettings] = None,
        num_workers: int = 1,
        prefetch: int = 4,
        epochs: int | None = None,
        seed: int = 0xBEEF,
        sample_rate: int = SAMPLE_RATE,
        audio_duration: float = MODEL_AUDIO_LENGTH,
        mini_batch_size: int = 16,
    ):
        self.dataset_dir = Path(dataset_dir)
        self.batch_size = batch_size
        self.num_model_output_frames = num_model_output_frames
        self.transform_settings = transform_settings
        self.sample_rate = sample_rate
        self.audio_duration = audio_duration
        self.mini_batch_size = mini_batch_size
        self.epochs = epochs
        self.queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads = []
        names = load_sample_names(self.dataset_dir)
        rng = np.random.default_rng(seed)
        self._names = [names[i] for i in rng.permutation(len(names))]
        for worker in range(num_workers):
            t = threading.Thread(
                target=self._worker, args=(seed + worker,), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _worker(self, seed: int):
        rng = np.random.default_rng(seed)
        audio_buf = np.zeros(
            (0, 2, int(self.audio_duration * self.sample_rate)), np.float16
        )
        event_buf = np.zeros(
            (0, self.num_model_output_frames, MIDI_EVENT_VOCAB_SIZE), np.float16
        )
        epoch = 0
        idx = 0
        order = rng.permutation(len(self._names))
        while not self._stop.is_set():
            take = [self._names[i] for i in order[idx : idx + self.mini_batch_size]]
            idx += self.mini_batch_size
            if idx >= len(order):
                idx = 0
                order = rng.permutation(len(self._names))
                epoch += 1
                if self.epochs is not None and epoch >= self.epochs:
                    self.queue.put(None)
                    return
            if self.transform_settings is not None:
                audio, events, _ = load_events_and_audio_with_transformations(
                    self.dataset_dir, take, self.sample_rate, self.audio_duration,
                    self.num_model_output_frames, self.transform_settings, rng=rng,
                )
            else:
                audio, events, _ = load_events_and_audio(
                    self.dataset_dir, take, self.sample_rate, self.audio_duration,
                    self.num_model_output_frames,
                )
            if not audio:
                continue
            audio_buf = np.concatenate([audio_buf, np.stack(audio).astype(np.float16)])
            event_buf = np.concatenate([event_buf, np.stack(events).astype(np.float16)])
            while audio_buf.shape[0] >= self.batch_size:
                batch = (event_buf[: self.batch_size], audio_buf[: self.batch_size])
                audio_buf = audio_buf[self.batch_size :]
                event_buf = event_buf[self.batch_size :]
                while not self._stop.is_set():
                    try:
                        self.queue.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        while True:
            item = self.queue.get()
            if item is None:
                return
            yield item

    def close(self):
        self._stop.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def create_dataset_loader(
    dataset_dir,
    batch_size: int,
    num_workers: int,
    num_epochs: int,
    sample_rate: int = SAMPLE_RATE,
    duration: float = MODEL_AUDIO_LENGTH,
    output_divisions: int = 250,
    transform_settings: Optional[TransformSettings] = None,
    seed: int = 42,
    use_grain: bool = True,
    *,
    threaded_seed: int = 0xBEEF,
):
    """The JAX package's signature and rule where grain is installed: the
    grain pipeline (:class:`GrainLoader`, ``seed`` its shuffle's) or, with
    ``use_grain=False``, the threaded loader, which ``threaded_seed`` seeds
    (the JAX package's 0xBEEF; a rank of a multi-process run takes its own).
    Either iterates over (events, audio) f16 batches and has ``close``."""
    if use_grain:
        return GrainLoader(
            _GrainBatches(
                _GrainSource(dataset_dir, output_divisions, sample_rate, duration,
                             transform_settings),
                batch_size, num_epochs, seed,
            ),
            num_workers,
        )
    return ThreadedBatchLoader(
        dataset_dir,
        batch_size,
        output_divisions,
        transform_settings,
        num_workers=max(1, num_workers),
        epochs=num_epochs,
        seed=threaded_seed,
        sample_rate=sample_rate,
        audio_duration=duration,
    )


# ---------------------------------------------------------------------------
# The grain pipeline (JAX data/loader.py:543-620), without grain
# ---------------------------------------------------------------------------


class _GrainSource(torch.utils.data.Dataset):
    """The JAX package's grain source: mini-batches of ``mini_batch_size``
    names, permuted once by ``default_rng(0xBEEF)``; item i is the f16
    (events, audio) windows of mini-batch i, augmented without a seed when
    ``transform_settings`` is given, as in JAX."""

    def __init__(
        self, dataset_dir, output_divisions, sample_rate, audio_duration,
        transform_settings, mini_batch_size=16,
    ):
        self.dataset_dir = Path(dataset_dir)
        self.output_divisions = output_divisions
        self.sample_rate = sample_rate
        self.audio_duration = audio_duration
        self.transform_settings = transform_settings
        self.mini_batch_size = mini_batch_size
        rng = np.random.default_rng(0xBEEF)
        names = load_sample_names(self.dataset_dir)
        self.all_sample_names = [names[i] for i in rng.permutation(len(names))]

    def __getitem__(self, idx):
        lo = idx * self.mini_batch_size
        take = self.all_sample_names[lo : lo + self.mini_batch_size]
        if self.transform_settings is not None:
            audio, events, _ = load_events_and_audio_with_transformations(
                self.dataset_dir, take, self.sample_rate, self.audio_duration,
                self.output_divisions, self.transform_settings,
            )
        else:
            audio, events, _ = load_events_and_audio(
                self.dataset_dir, take, self.sample_rate, self.audio_duration,
                self.output_divisions,
            )
        return (
            np.stack(events).astype(np.float16),
            np.stack(audio).astype(np.float16),
        )

    def __len__(self):
        return max(1, int(len(self.all_sample_names) / self.mini_batch_size))


def _shuffle_seed(seed: int) -> int:
    """The seed grain's ``.seed(seed).repeat(E).shuffle()`` gives its
    shuffle: a ``SeedSequence`` of the pipeline's seed and the depth, 2, of
    the ``seed`` node below the shuffle."""
    return int(np.random.SeedSequence([seed, 2]).generate_state(1, np.uint32)[0])


class _GrainBatches(torch.utils.data.Dataset):
    """Batch j of grain's ``MapDataset.source(source).seed(seed)
    .repeat(num_epochs).shuffle().batch(batch_size // 16)``: one
    permutation over all ``len(source) * num_epochs`` mini-batches (so the
    epochs mix), grouped in order, the last group short; each group's
    fields concatenated and cropped or zero-padded to ``batch_size``."""

    def __init__(self, source: _GrainSource, batch_size: int, num_epochs: int, seed: int):
        self.source = source
        self.batch_size = batch_size
        self.total = len(source) * num_epochs
        self.per_batch = max(1, int(batch_size / source.mini_batch_size))
        self.seed = _shuffle_seed(seed)

    def __len__(self):
        return math.ceil(self.total / self.per_batch)

    def mini_batches(self, j: int) -> np.ndarray:
        """The source's mini-batches that make batch ``j``."""
        stream = np.arange(j * self.per_batch, min((j + 1) * self.per_batch, self.total))
        return index_shuffle_array(stream, self.total - 1, self.seed) % len(self.source)

    def __getitem__(self, j):
        if not 0 <= j < len(self):
            raise IndexError(j)
        parts = [self.source[int(i)] for i in self.mini_batches(j)]
        return tuple(self._crop_or_pad(np.concatenate(field)) for field in zip(*parts))

    def _crop_or_pad(self, batched: np.ndarray) -> np.ndarray:
        if batched.shape[0] < self.batch_size:
            padded = np.zeros((self.batch_size, *batched.shape[1:]), batched.dtype)
            padded[: batched.shape[0]] = batched
            batched = padded
        return batched[: self.batch_size]


class GrainLoader:
    """The grain pipeline's stream through ``torch.utils.data``: item j of
    the DataLoader is batch j, taken in order (a sequential sampler, no
    batching of its own), so any number of workers gives the same stream.
    ``num_workers`` > 0 decodes in that many worker processes, each with
    ``prefetch_factor`` 4, as grain's ``prefetch_buffer_size``, kept for the
    whole run; 0 decodes in this process.  The workers are forked from a
    forkserver, never from this process: by the time training builds the
    loader it has initialised CUDA and runs threads.  The server imports
    the main module and this one (torch with it) once, and serves every
    later loader of the process, whose workers see the environment it
    started with (``A2M_DISABLE_NATIVE``, ``SAMPLE_CACHE_DIR``); each loads
    the native plane on its own.  A worker's exception re-raises from the
    iteration.  ``first_batch_s``: the wall from ``iter()`` (the workers'
    start) to the first batch."""

    def __init__(self, batches: _GrainBatches, num_workers: int):
        self.transform_settings = batches.source.transform_settings
        self.first_batch_s: Optional[float] = None
        workers = {}
        if num_workers > 0:
            context = multiprocessing.get_context("forkserver")
            context.set_forkserver_preload(["__main__", __name__])
            workers = {"multiprocessing_context": context, "prefetch_factor": 4,
                       "persistent_workers": True}
        # batch_size=None: the items are whole batches; default_convert hands
        # them over as tensors (shared memory from a worker).
        self._loader = torch.utils.data.DataLoader(
            batches, batch_size=None, shuffle=False, num_workers=num_workers,
            in_order=True, **workers)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        t0 = time.perf_counter()
        return self._stream(iter(self._loader), t0)

    def _stream(self, it, t0: float):
        for events, audio in it:
            if self.first_batch_s is None:
                self.first_batch_s = time.perf_counter() - t0
            yield events.numpy(), audio.numpy()

    def close(self):
        """Stop the worker processes."""
        it, self._loader._iterator = self._loader._iterator, None
        if it is not None:  # persistent workers only
            it._shutdown_workers()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
