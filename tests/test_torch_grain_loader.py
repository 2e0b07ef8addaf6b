"""The port's grain pipeline (``data/loader.py``: ``GrainLoader`` over
``_GrainBatches`` and ``_GrainSource``; ``data/index_shuffle.py``) against
grain and the JAX package's ``create_dataset_loader(use_grain=True)``: grain's
C++ ``index_shuffle`` bit for bit, its shuffle's order, and the JAX stream of
batches bit for bit, in process and from worker processes; the threaded
loader with ``use_grain=False``; ``train_cli`` on the pipeline."""

import dataclasses
import logging

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu.data import loader as jax_loader
from audio_to_midi_tpu_torch import config as pt_config
from audio_to_midi_tpu_torch.data import index_shuffle as ish
from audio_to_midi_tpu_torch.data import loader as pt_loader
from audio_to_midi_tpu_torch.data import synthetic
from tests.test_e2e import E2E_CFG

torch.set_num_threads(2)

# 0.6 s files in 0.5 s windows: one window each (the 0.1 s rest is dropped),
# so a mini-batch of 16 names holds 16 windows.  50 names make 3 mini-batches
# (the last 2 names are never read, as in JAX), so the shuffle has an order
# to get wrong.
WINDOW = dict(duration=0.5, output_divisions=50)
# (batch_size, num_epochs, seed): a mini-batch cropped to 2 windows; two
# mini-batches per batch of 32, with 9 = 3 x 3 mini-batches the last batch
# holds one, zero-padded; one epoch, 2 batches, the second padded.
STREAMS = [(2, 3, 42), (32, 3, 5), (32, 1, 0)]


def _grain_index_shuffle():
    pytest.importorskip("grain")
    from grain._src.python.experimental.index_shuffle.python import index_shuffle_module

    return index_shuffle_module.index_shuffle


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("grain_set")
    synthetic.make_synthetic_dataset(d, num_samples=50, duration_s=0.6, notes_per_sample=2,
                                     seed=4)
    return d


def _same(ours, ref) -> None:
    assert len(ours) == len(ref)
    for (e1, a1), (e2, a2) in zip(ours, ref):
        assert e1.dtype == a1.dtype == np.float16 == e2.dtype == a2.dtype
        assert np.array_equal(e1, e2) and np.array_equal(a1, a2)


def _jax_stream(d, batch_size, num_epochs, seed):
    pytest.importorskip("grain")
    return list(jax_loader.create_dataset_loader(d, batch_size, 0, num_epochs, seed=seed,
                                                 use_grain=True, **WINDOW))


# --- index_shuffle ------------------------------------------------------------------


@settings(max_examples=150, deadline=None, database=None, derandomize=True)
@given(max_index=st.integers(0, 2**40), at=st.floats(0.0, 1.0),
       seed=st.integers(0, 2**32 - 1))
def test_index_shuffle_is_grains(max_index, at, seed):
    grain_shuffle = _grain_index_shuffle()
    index = min(int(at * max_index), max_index)
    ref = grain_shuffle(index, max_index=max_index, seed=seed, rounds=4)
    assert ish.index_shuffle(index, max_index, seed) == ref


@pytest.mark.parametrize("lengths", [range(1, 101), range(101, 201, 3), range(201, 301, 7)],
                         ids=["1-100", "101-200", "201-300"])
def test_index_shuffle_whole_permutations_are_grains(lengths):
    grain_shuffle = _grain_index_shuffle()
    for n in lengths:
        seed = (n * 2654435761) % 2**32
        ref = [grain_shuffle(i, max_index=n - 1, seed=seed, rounds=4) for i in range(n)]
        assert ish.index_shuffle_array(np.arange(n), n - 1, seed).tolist() == ref, n
        assert sorted(ref) == list(range(n))


def test_index_shuffle_edges_and_rounds():
    grain_shuffle = _grain_index_shuffle()
    # Blocks of 16 bits up to 2^16; 2^16 and 2^18 are their own blocks'
    # size, whose top value grain never reaches; 6 and 8 rounds.
    for max_index in (1, 65535, 65536, 65537, 2**18, 2**18 + 1, 2**31 + 5):
        idx = [0, 1, max_index // 2, max_index - 1, max_index]
        for rounds in (4, 6, 8):
            ref = [grain_shuffle(i, max_index=max_index, seed=7, rounds=rounds) for i in idx]
            assert ish.index_shuffle_array(idx, max_index, 7, rounds).tolist() == ref
    assert ish.index_shuffle(0, 0, 3) == 0
    with pytest.raises(ValueError, match="rounds"):
        ish.index_shuffle(0, 10, 3, rounds=3)


# --- the order ----------------------------------------------------------------------


class _Source:
    """A stand-in for _GrainSource's length: ``n`` mini-batches."""

    mini_batch_size = 16
    transform_settings = None

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n


def test_the_order_mixes_epochs_as_grains():
    batches = pt_loader._GrainBatches(_Source(7), 16, 3, 42)
    order = np.concatenate([batches.mini_batches(j) for j in range(len(batches))]).tolist()
    # One permutation over the 21 mini-batches of 3 epochs: 6 comes back
    # before 0, 1 and 2 have come once.
    assert order[:7] == [4, 5, 6, 3, 6, 4, 0]
    assert sorted(order) == sorted(list(range(7)) * 3)
    pytest.importorskip("grain")
    import grain.python as grain

    for n, epochs, seed, per in ((7, 3, 42, 1), (5, 4, 0, 3), (3, 100_000, 2**32 - 1, 2)):
        batches = pt_loader._GrainBatches(_Source(n), 16 * per, epochs, seed)
        ref = grain.MapDataset.range(n).seed(seed).repeat(epochs).shuffle().batch(per)
        for j in (0, 1, len(ref) // 2, len(ref) - 1):
            assert batches.mini_batches(j).tolist() == np.asarray(ref[j]).tolist()
        assert len(batches) == len(ref)


# --- the stream ---------------------------------------------------------------------


@pytest.mark.parametrize("batch_size,num_epochs,seed", STREAMS)
def test_the_stream_is_jaxs(dataset, batch_size, num_epochs, seed):
    ref = _jax_stream(dataset, batch_size, num_epochs, seed)
    loader = pt_loader.create_dataset_loader(dataset, batch_size, 0, num_epochs, seed=seed,
                                             **WINDOW)
    assert isinstance(loader, pt_loader.GrainLoader) and loader.transform_settings is None
    with loader:
        ours = list(loader)
    _same(ours, ref)
    padded = [int((np.abs(a.astype(np.float32)).sum(axis=(1, 2)) == 0).sum()) for _, a in ours]
    assert padded[-1] == (16 if batch_size == 32 else 0) and not any(padded[:-1])


def test_the_stream_from_worker_processes_is_jaxs_and_a_failing_worker_raises(dataset,
                                                                             tmp_path):
    """One test for the spawned workers: each imports torch.  A second
    loader, over a set with an undecodable WAV, starts its worker beside
    them."""
    synthetic.make_synthetic_dataset(tmp_path, num_samples=3, duration_s=0.6,
                                     notes_per_sample=2, seed=5)
    (tmp_path / "sample_001.wav").write_bytes(b"RIFF not a wav file")
    good = pt_loader.create_dataset_loader(dataset, 32, 2, 3, seed=5, **WINDOW)
    bad = pt_loader.create_dataset_loader(tmp_path, 2, 1, 1, **WINDOW)
    with good, bad:
        good_stream, bad_stream = iter(good), iter(bad)
        ours = list(good_stream)
        with pytest.raises(Exception, match="DataLoader worker process 0"):
            next(bad_stream)
    _same(ours, _jax_stream(dataset, 32, 3, 5))
    assert good.first_batch_s is not None and good.first_batch_s > 0


def test_use_grain_false_builds_the_threaded_loader(dataset):
    loader = pt_loader.create_dataset_loader(dataset, 2, 0, 1, use_grain=False, **WINDOW)
    assert isinstance(loader, pt_loader.ThreadedBatchLoader)
    with loader:
        batches = list(loader)
    # Whole windows only: 48 of the 50, as JAX's threaded loader ends its
    # epoch before the last, short chunk of names (50 = 3 x 16 + 2).
    assert len(batches) == 24 and all(a.shape == (2, 2, 8000) for _, a in batches)
    assert all((np.abs(a.astype(np.float32)).sum(axis=(1, 2)) > 0).all() for _, a in batches)


# --- train_cli ----------------------------------------------------------------------


def test_train_cli_trains_on_the_pipeline(dataset, tmp_path, monkeypatch, caplog):
    from audio_to_midi_tpu_torch.cli import train_cli
    from audio_to_midi_tpu_torch.train import loop

    cfg = pt_config.config_from_json(jax_config.config_to_json(dataclasses.replace(
        E2E_CFG, transforms=None)))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, minibatch_size_per_device=cfg.train.batch_size, print_every=1,
        input_ring_capacity=0, dataset_num_workers=0, checkpoint_every=1000))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(pt_config.config_to_json(cfg))
    built, hooks = [], []
    real_build, real_train = pt_loader.create_dataset_loader, loop.train

    def build(*args, **kwargs):
        built.append(kwargs)
        return real_build(*args, **kwargs)

    def train(*args, **kwargs):
        built[-1]["loader"] = args[4]
        return real_train(*args, step_hook=lambda step, info: hooks.append((step, info)),
                          **kwargs)

    monkeypatch.setattr(pt_loader, "create_dataset_loader", build)
    monkeypatch.setattr(loop, "train", train)
    base = ["--dataset", str(dataset), "--config", str(cfg_path), "--no-tensorboard",
            "--device", "cpu", "--steps", "2"]
    with caplog.at_level(logging.INFO):
        assert train_cli.main(base + ["--checkpoint", str(tmp_path / "ck")]) == 0
    assert isinstance(built[0]["loader"], pt_loader.GrainLoader)
    assert built[0]["seed"] == 42 and built[0]["use_grain"]
    assert [s for s, _ in hooks] == [1, 2]
    assert all(np.isfinite(info["loss"]).all() for _, info in hooks)
    # --threaded-loader (use_grain=False) trains in test_torch_cli_tools.py's f16 run.
    assert built[0]["threaded_seed"] == 0xBEEF
    assert train_cli.build_parser().parse_args(base + ["--threaded-loader"]).threaded_loader
