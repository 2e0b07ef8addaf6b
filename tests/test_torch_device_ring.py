"""The port's device input ring (audio_to_midi_tpu_torch/data/device_ring.py)
on CPU tensors: the cases of tests/test_device_ring.py -- push and
wraparound, capacity rounding, sampling only pushed content, the feeder's
exhaustion and exceptions, undersized chunks raising and not hanging,
pull(max_chunks), reuse telemetry."""

import time
import warnings

import numpy as np
import pytest
import torch

from audio_to_midi_tpu_torch.config import TransformSettings
from audio_to_midi_tpu_torch.data.device_ring import DeviceInputRing, _Feeder, ring_feed

torch.set_num_threads(2)


def _chunk(start, w=4, n=32, f=8, k=90):
    """A feed chunk whose window i is filled with (start + i)."""
    ids = np.arange(start, start + w, dtype=np.float16)
    audio = np.broadcast_to(ids[:, None, None], (w, 2, n)).copy()
    labels = np.broadcast_to(ids[:, None, None], (w, f, k)).copy()
    return audio, labels


def _feed(*starts, w=4):
    return [(_chunk(s, w)[1], _chunk(s, w)[0]) for s in starts]  # (events, audio)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_ring_push_and_wraparound():
    ring = DeviceInputRing(capacity=8, chunk_windows=4)
    ring.push(*_chunk(0))
    assert ring.filled == 4 and ring.capacity == 8
    ring.push(*_chunk(4))
    assert ring.filled == 8
    ring.push(*_chunk(8))  # wraps: slots 0..3 now hold windows 8..11
    assert ring._audio.dtype == torch.float16
    assert ring._audio[:, 0, 0].float().tolist() == [8, 9, 10, 11, 4, 5, 6, 7]
    assert ring.filled == 8 and ring.pushed_windows == 12
    with pytest.raises(ValueError, match="4 windows"):
        ring.push(*_chunk(0, w=2))


def test_ring_capacity_rounds_up_to_chunk():
    assert DeviceInputRing(capacity=6, chunk_windows=4).capacity == 8


def test_ring_sample_draws_only_pushed_content():
    ring = DeviceInputRing(capacity=8, chunk_windows=4)
    ring.push(*_chunk(0))
    audio_mb, labels_mb = ring.sample(_gen(), batch=8, minibatch=2, settings=None)
    assert audio_mb.shape == (4, 2, 2, 32) and labels_mb.shape == (4, 2, 8, 90)
    assert audio_mb.dtype == labels_mb.dtype == torch.float32
    ids = audio_mb[:, :, 0, 0].flatten()
    assert set(ids.tolist()) <= {0.0, 1.0, 2.0, 3.0}
    assert torch.equal(ids, labels_mb[:, :, 0, 0].flatten())  # audio and labels paired


def test_ring_sample_with_augmentation():
    ring, feeder = ring_feed(iter([]), capacity=8, chunk_windows=8, audio_shape=(2, 32),
                             label_shape=(8, 90))
    ring.push(*_chunk(0, w=8))
    audio_mb, labels_mb = ring.sample(_gen(1), batch=8, minibatch=4, settings=TransformSettings())
    assert torch.isfinite(audio_mb).all() and torch.isfinite(labels_mb).all()
    assert labels_mb.min() >= 0.005 - 1e-6  # label smoothing
    again = ring.sample(_gen(1), batch=8, minibatch=4, settings=TransformSettings())
    assert torch.equal(again[0], audio_mb)  # the same generator state, the same batch


def test_feeder_drains_and_reports_exhaustion():
    feeder = _Feeder(iter(_feed(0, 4, 8)), depth=2)
    ring = DeviceInputRing(capacity=16, chunk_windows=4)
    ring.pull(feeder, min_fill=12)
    assert ring.filled == 12
    ring.pull(feeder, min_fill=16)  # exhausted: returns with what it has
    assert ring.filled == 12 and feeder.exhausted


def test_feeder_exhausted_before_any_data_raises():
    ring = DeviceInputRing(capacity=8, chunk_windows=4)
    with pytest.raises(RuntimeError, match="exhausted before any batch"):
        ring.pull(_Feeder(iter([]), depth=2), min_fill=4)


def test_feeder_source_exception_propagates():
    def bad_source():
        yield _feed(0)[0]
        raise OSError("corrupt audio file")

    feeder = _Feeder(bad_source(), depth=2)
    ring = DeviceInputRing(capacity=8, chunk_windows=4)
    with pytest.raises(RuntimeError, match="input feed thread failed") as ei:
        for _ in range(4):
            ring.pull(feeder, min_fill=8)
    assert isinstance(ei.value.__cause__, OSError)


def test_feeder_drops_non_finite_chunks_and_aborts_on_a_streak():
    bad = _feed(0)[0]
    bad[1][0, 0, 0] = np.nan
    feeder = _Feeder(iter([bad] + _feed(4)), depth=2)
    ring = DeviceInputRing(capacity=8, chunk_windows=4)
    ring.pull(feeder, min_fill=4)
    assert ring._audio[:4, 0, 0].float().tolist() == [4, 5, 6, 7]
    feeder = _Feeder(iter([bad] * 8), depth=2)
    with pytest.raises(RuntimeError, match="input feed thread failed"):
        DeviceInputRing(capacity=8, chunk_windows=4).pull(feeder, min_fill=4)


def test_undersized_feed_chunk_raises():
    feeder = _Feeder(iter(_feed(0, w=2)), depth=2)
    ring = DeviceInputRing(capacity=8, chunk_windows=4)
    with pytest.raises(ValueError, match="2 windows"):
        ring.pull(feeder, min_fill=4)


def test_persistent_undersized_chunks_raise_not_hang():
    chunks = _feed(0) + _feed(*([4] * 50), w=2)
    ring = DeviceInputRing(capacity=16, chunk_windows=4)
    with pytest.raises(ValueError, match="2 windows"):
        ring.pull(_Feeder(iter(chunks), depth=2), min_fill=16)
    assert ring.filled == 4  # the one full chunk landed


def test_single_trailing_partial_chunk_tolerated():
    chunks = _feed(0, 4) + _feed(8, w=2)
    feeder = _Feeder(iter(chunks), depth=2)
    ring = DeviceInputRing(capacity=16, chunk_windows=4)
    ring.pull(feeder, min_fill=16)
    assert ring.filled == 8 and feeder.exhausted


def test_oversized_chunks_split():
    ring = DeviceInputRing(capacity=16, chunk_windows=4)
    ring.pull(_Feeder(iter(_feed(0, w=10)), depth=2), min_fill=16)
    assert ring.filled == 8  # two whole chunks; the trailing 2 windows dropped


def test_pull_max_chunks_drains_that_many():
    feeder = _Feeder(iter(_feed(*range(0, 24, 4))), depth=8)
    deadline = time.monotonic() + 30
    while feeder._q.qsize() < 7 and time.monotonic() < deadline:  # six chunks and the end
        time.sleep(0.01)
    ring = DeviceInputRing(capacity=64, chunk_windows=4)
    ring.pull(feeder, min_fill=4, max_chunks=0)
    first = ring.pushed_windows
    assert first >= 4
    ring.pull(feeder, min_fill=4, max_chunks=2)
    assert ring.pushed_windows == first + 8
    ring.pull(feeder, min_fill=4, max_chunks=None)
    assert ring.pushed_windows == 24


def test_take_stats_reuse_telemetry():
    ring = DeviceInputRing(capacity=8, chunk_windows=4)
    ring.push(*_chunk(0))
    ring.push(*_chunk(4))
    for i in range(4):
        ring.sample(_gen(i), batch=8, minibatch=4, settings=None)
    stats = ring.take_stats()
    assert stats["interval_refreshed_windows"] == 8
    assert stats["interval_sampled_windows"] == 32
    assert stats["reuse_factor"] == pytest.approx(4.0)
    assert stats["pushed_windows"] == 8 and stats["sampled_windows"] == 32
    assert stats["filled"] == 8 and stats["capacity"] == 8

    ring.sample(_gen(9), batch=8, minibatch=4, settings=None)
    stats2 = ring.take_stats()
    assert stats2["interval_refreshed_windows"] == 0
    assert stats2["interval_sampled_windows"] == 8 and stats2["sampled_windows"] == 40

    ring.sample(_gen(10), batch=8, minibatch=4, settings=None)
    with pytest.warns(UserWarning, match="reuse factor"):
        ring.take_stats(reuse_warn_factor=1.0)

    ring.push(*_chunk(8))
    ring.push(*_chunk(12))
    ring.sample(_gen(11), batch=8, minibatch=4, settings=None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        stats3 = ring.take_stats(reuse_warn_factor=2.0)
    assert stats3["reuse_factor"] == pytest.approx(1.0)
