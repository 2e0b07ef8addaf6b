"""Device-resident training input ring.

Counterpart of ``audio_to_midi_tpu/data/device_ring.py``.  The pool of
training windows lives on the model's device in f16 -- at the default 1024
windows of (2, 80 000) samples, ~328 MB of audio and
~46 MB of labels on the card -- and each step's batch is sampled, augmented
(``data/augment_device.py``) and minibatched there.  The host refreshes
ring slots asynchronously; a slot is reused, with fresh augmentation, until
its refresh lands (epoch-style sample reuse, made visible by
:meth:`DeviceInputRing.take_stats`).

The wire format is f16: decoded audio is already f16-rounded (the
reference's decode dtype), so the audio copy is lossless; label rasters
lose < 5e-4.

On the card:
  * the feeder thread (:class:`_Feeder`) converts each loader chunk to f16
    and copies it into page-locked host memory, off the training thread;
  * the pool is zero-filled on the training stream, and the side stream
    waits for that fill before its first copy;
  * :meth:`DeviceInputRing.push` copies a chunk into its ring slot on a side
    CUDA stream, after the last batch sampled from the ring (an event on the
    training stream), so a queued gather never reads a slot mid-refresh; it
    keeps the page-locked chunk alive until the copy's event has completed
    (the caching host allocator also records that event);
  * :meth:`DeviceInputRing.sample` makes the training stream wait for the
    last copy's event before its gather.
The ring's own tensors live for the ring's lifetime and are recorded on the
side stream (``record_stream``), so the caching allocator never hands their
memory out while a copy is pending.

Mesh mode (``mesh=``, several processes), as JAX's multi-host mode: the
pool is replicated on every rank; each rank's feed yields its local
``chunk / world`` windows, and :meth:`DeviceInputRing.push` gathers the
whole chunk over the world (in rank order, in host memory) and copies it
into the same slot on every rank, on the side stream as above.  The refresh must then run in lockstep
(:meth:`DeviceInputRing.pull_lockstep`, JAX's discipline and error texts:
block for ``min_fill``, then exactly ``refresh_chunks`` chunks per call),
and :meth:`DeviceInputRing.sample` draws the same global batch on every
rank -- the same generator state, the same augmentation, which sees what
JAX's global program sees -- and returns this rank's ``"data"`` slice of
each minibatch.
"""

from __future__ import annotations

import logging
import queue
import threading
import warnings
from typing import Iterable, Optional

import numpy as np
import torch

from ..config import TransformSettings
from ..parallel.mesh import Mesh, local_minibatches
from .augment_device import augment_, draw


class _Feeder:
    """Background thread that pulls (events, audio) chunks off a (possibly
    blocking) iterable, converts them to f16 and, for a CUDA ring, into
    page-locked memory.  A data-source exception re-raises in
    :meth:`get`."""

    _DONE = object()

    def __init__(self, source: Iterable, depth: int = 2, pin_memory: bool = False):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._pin = pin_memory
        self._thread = threading.Thread(target=self._run, args=(source,), daemon=True)
        self._done = False
        self._error: Optional[BaseException] = None
        self._thread.start()

    def _run(self, source):
        nonfinite_streak = 0
        try:
            for events, audio in source:
                audio_np = np.ascontiguousarray(np.asarray(audio), dtype=np.float16)
                events_np = np.ascontiguousarray(np.asarray(events), dtype=np.float16)
                # A non-finite window must not enter the pool: ring slots are
                # resampled for many steps.  A source that gives only
                # garbage aborts training.
                if not (np.isfinite(audio_np).all() and np.isfinite(events_np).all()):
                    nonfinite_streak += 1
                    if nonfinite_streak >= 8:
                        raise RuntimeError(
                            "input source produced 8 non-finite feed chunks in a row -- "
                            "corrupt dataset or broken decoder")
                    logging.getLogger(__name__).warning(
                        "dropping feed chunk with non-finite values (corrupt input?) -- "
                        "not admitting it to the ring pool")
                    continue
                nonfinite_streak = 0
                audio_t, events_t = torch.from_numpy(audio_np), torch.from_numpy(events_np)
                if self._pin:
                    audio_t, events_t = audio_t.pin_memory(), events_t.pin_memory()
                self._q.put((audio_t, events_t))
        except BaseException as e:  # propagate to the training thread
            self._error = e
        finally:
            self._q.put(self._DONE)

    def get(self, block: bool) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
        """The next (audio f16, labels f16) chunk, or None: nothing ready
        (non-blocking) or the source exhausted."""
        if self._done:
            self._raise_if_failed()
            return None
        try:
            item = self._q.get(block=block, timeout=None if not block else 600)
        except queue.Empty:
            return None
        if item is self._DONE:
            self._done = True
            self._raise_if_failed()
            return None
        return item

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            raise RuntimeError("training input feed thread failed") from self._error

    @property
    def exhausted(self) -> bool:
        return self._done


class DeviceInputRing:
    """Device-resident window pool with an asynchronous host refresh.

    ``capacity`` is rounded up to a multiple of the feed chunk size so a
    refresh never wraps.  ``mesh`` (more than one rank) switches on mesh
    mode (see the module docstring)."""

    def __init__(
        self,
        capacity: int,
        chunk_windows: int,
        audio_shape: Optional[tuple[int, ...]] = None,
        label_shape: Optional[tuple[int, ...]] = None,
        dtype: torch.dtype = torch.float16,
        device: torch.device | str = "cpu",
        mesh: Optional[Mesh] = None,
    ):
        self._mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._world = 1 if self._mesh is None else self._mesh.size
        if chunk_windows % self._world:
            raise ValueError(
                f"chunk of {chunk_windows} windows does not divide over "
                f"{self._world} processes"
            )
        self.chunk = chunk_windows
        self.capacity = -(-capacity // chunk_windows) * chunk_windows
        self.dtype = dtype
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._written = None   # event: the last refresh copy
        self._sampled = None   # event: the last gather off the ring
        self._inflight: list = []  # (event, host chunk) until the copy completes
        self._audio = self._labels = None
        if audio_shape is not None and label_shape is not None:
            self._alloc(audio_shape, label_shape)
        self._write = 0
        self.filled = 0
        self.pushed_windows = 0
        self.sampled_windows = 0
        self._interval_pushed = 0
        self._interval_sampled = 0

    def _alloc(self, audio_shape, label_shape) -> None:
        self._audio = torch.zeros((self.capacity, *audio_shape), dtype=self.dtype,
                                  device=self.device)
        self._labels = torch.zeros((self.capacity, *label_shape), dtype=self.dtype,
                                   device=self.device)
        if self._cuda:
            # The fill runs on the training stream: the side stream's first
            # copy must not overtake it.
            self._side.wait_stream(torch.cuda.current_stream(self.device))
            self._audio.record_stream(self._side)
            self._labels.record_stream(self._side)

    def push(self, audio, labels) -> None:
        """Copy one feed chunk (host arrays or tensors, ``chunk`` windows)
        into the next ring slots, asynchronously on the card.  In mesh mode
        ``audio`` and ``labels`` are this rank's ``chunk / world`` windows,
        and every rank must push in lockstep."""
        w = audio.shape[0] * self._world
        if w != self.chunk:
            raise ValueError(f"a push takes {self.chunk} windows, got {w}")
        audio = torch.as_tensor(audio)
        labels = torch.as_tensor(labels)
        if self._mesh is not None:
            # Gathered in host memory (gloo's own; NCCL's backend stages it
            # through the card), off the training stream; then copied as
            # one rank's chunk is.
            audio, labels = (self._mesh.all_gather(t.cpu(), None).flatten(0, 1)
                             for t in (audio, labels))
            if self._cuda:
                audio, labels = audio.pin_memory(), labels.pin_memory()
        if self._audio is None:
            self._alloc(audio.shape[1:], labels.shape[1:])
        lo, hi = self._write, self._write + w
        if self._cuda:
            self._inflight = [(e, c) for e, c in self._inflight if not e.query()]
            with torch.cuda.stream(self._side):
                if self._sampled is not None:
                    self._side.wait_event(self._sampled)
                self._audio[lo:hi].copy_(audio, non_blocking=True)
                self._labels[lo:hi].copy_(labels, non_blocking=True)
                self._written = torch.cuda.Event()
                self._written.record(self._side)
            self._inflight.append((self._written, (audio, labels)))
        else:
            self._audio[lo:hi].copy_(audio)
            self._labels[lo:hi].copy_(labels)
        self._write = hi % self.capacity
        self.filled = min(self.filled + w, self.capacity)
        self.pushed_windows += w
        self._interval_pushed += w

    def pull(self, feeder: _Feeder, *, min_fill: int, max_chunks: int | None = None) -> None:
        """Drain what the feeder has ready (non-blocking); block only while
        the ring holds fewer than ``min_fill`` windows.  ``max_chunks`` caps
        the non-blocking refresh per call."""
        taken = 0
        stalls = 0
        undersized_streak = 0
        while True:
            need = self.filled < min_fill
            if need and feeder.exhausted:
                if self.filled == 0:
                    raise RuntimeError("data source exhausted before any batch")
                return
            if not need and max_chunks is not None and taken >= max_chunks:
                return
            item = feeder.get(block=need)
            if item is None:
                if need:
                    # The sentinel, or the 600 s timeout: the exhaustion
                    # check decides, but a live source that never produces
                    # fails loudly.
                    stalls += 1
                    if stalls >= 3 and not feeder.exhausted:
                        raise RuntimeError(
                            "training input feed produced nothing for "
                            f"~{stalls * 600} s while the ring needs data "
                            f"({self.filled}/{min_fill} windows) -- stuck loader/decoder?")
                    continue
                return
            stalls = 0
            taken += 1
            audio, labels = item
            if audio.shape[0] < self.chunk:
                # One trailing partial chunk (finite sources) is dropped; the
                # first chunk, or two in a row, undersized means the loader's
                # batch is smaller than the ring's chunk.
                undersized_streak += 1
                if self.pushed_windows == 0 or undersized_streak >= 2:
                    raise ValueError(
                        f"feed chunks carry {audio.shape[0]} windows but the ring updates "
                        f"in chunks of {self.chunk}: the data loader's batch size must be "
                        ">= the training batch size (smaller chunks are dropped and the "
                        "ring would never refresh)")
                continue
            undersized_streak = 0
            for lo in range(0, audio.shape[0] - self.chunk + 1, self.chunk):
                self.push(audio[lo: lo + self.chunk], labels[lo: lo + self.chunk])

    def pull_lockstep(self, feeder: _Feeder, *, min_fill: int, refresh_chunks: int) -> None:
        """The refresh of mesh mode: every rank takes exactly the same
        number of chunks per call, blocking, so that the pool and the
        gathers stay in lockstep across ranks.  Block until ``min_fill``
        during the initial fill, then for ``refresh_chunks`` whole chunks
        per call.  Every rank's feed must yield the same number of chunks:
        exhaustion must be simultaneous."""
        local_chunk = self.chunk // self._world
        target = refresh_chunks
        while self.filled < min_fill or target > 0:
            item = feeder.get(block=True)
            if item is None:
                if feeder.exhausted:
                    if self.filled == 0:
                        raise RuntimeError("data source exhausted before any batch")
                    return
                raise RuntimeError(
                    "multi-host training input feed produced nothing for "
                    f"~600 s ({self.filled}/{min_fill} windows) — stuck "
                    "loader/decoder?"
                )
            audio, labels = item
            if audio.shape[0] < local_chunk:
                raise ValueError(
                    f"feed chunks carry {audio.shape[0]} local windows but "
                    f"the multi-host ring updates in local chunks of "
                    f"{local_chunk}: the per-process loader batch must be >= "
                    "batch_size // process_count"
                )
            pushed = False
            for lo in range(0, audio.shape[0] - local_chunk + 1, local_chunk):
                self.push(audio[lo: lo + local_chunk], labels[lo: lo + local_chunk])
                pushed = True
            if pushed:
                target -= 1

    def sample(self, generator: torch.Generator, batch: int, minibatch: int,
               settings: TransformSettings | None):
        """A batch drawn uniformly with replacement from the filled slots,
        as float32, augmented with ``settings`` (None: not augmented) and
        reshaped to (batch // minibatch, minibatch, ...).  Every draw comes
        from the CPU ``generator``.  In mesh mode: this rank's ``"data"``
        slice of each minibatch of the global batch."""
        self.sampled_windows += batch
        self._interval_sampled += batch
        idx = torch.randint(0, max(self.filled, 1), (batch,), generator=generator)
        draws = None
        if settings is not None:
            draws = draw(settings, batch, self._audio.shape[-1], self._labels.shape[1],
                         generator, self.device)
        if self._cuda:
            idx = idx.pin_memory().to(self.device, non_blocking=True)
            if self._written is not None:
                torch.cuda.current_stream(self.device).wait_event(self._written)
        else:
            idx = idx.to(self.device)
        audio = self._audio.index_select(0, idx).float()
        labels = self._labels.index_select(0, idx).float()
        if self._cuda:
            self._sampled = torch.cuda.Event()
            self._sampled.record(torch.cuda.current_stream(self.device))
        if draws is not None:
            augment_(audio, labels, draws)
        audio = audio.reshape(batch // minibatch, minibatch, *audio.shape[1:])
        labels = labels.reshape(batch // minibatch, minibatch, *labels.shape[1:])
        if self._mesh is not None:
            return (local_minibatches(audio, self._mesh).contiguous(),
                    local_minibatches(labels, self._mesh).contiguous())
        return audio, labels

    def take_stats(self, reuse_warn_factor: Optional[float] = None) -> dict:
        """Reuse and refresh telemetry since the previous call (and over the
        ring's life).  ``reuse_factor`` is windows sampled per window
        refreshed over the interval: 1.0 means every consumed window was
        fresh; past ``reuse_warn_factor`` a warning is emitted, never an
        error."""
        interval_pushed = self._interval_pushed
        interval_sampled = self._interval_sampled
        self._interval_pushed = 0
        self._interval_sampled = 0
        reuse = interval_sampled / max(interval_pushed, 1)
        stats = {
            "filled": self.filled,
            "capacity": self.capacity,
            "pushed_windows": self.pushed_windows,
            "sampled_windows": self.sampled_windows,
            "interval_refreshed_windows": interval_pushed,
            "interval_sampled_windows": interval_sampled,
            "reuse_factor": reuse,
        }
        if reuse_warn_factor is not None and interval_sampled > 0 and reuse > reuse_warn_factor:
            warnings.warn(
                f"input ring reuse factor {reuse:.1f} exceeds {reuse_warn_factor:.1f} "
                f"(sampled {interval_sampled} windows while refreshing {interval_pushed}): "
                "the feed is starved and training is re-seeing resident windows "
                "epoch-style -- raise loader workers or accept the sample reuse",
                stacklevel=2,
            )
        return stats


def ring_feed(
    data_loader: Iterable,
    *,
    capacity: int,
    chunk_windows: int,
    audio_shape: tuple[int, ...],
    label_shape: tuple[int, ...],
    device: torch.device | str = "cpu",
    mesh: Optional[Mesh] = None,
) -> tuple[DeviceInputRing, _Feeder]:
    ring = DeviceInputRing(capacity, chunk_windows, audio_shape, label_shape, device=device,
                           mesh=mesh)
    return ring, _Feeder(data_loader, pin_memory=ring.device.type == "cuda")
