"""The port's host data pipeline against the JAX package's: labels, the
rasterizers, the synthetic dataset, host augmentation, window loading and the
threaded batch loader -- bit for bit, on the native and the numpy paths --
and the config's transforms section."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu.data import augment as jax_augment
from audio_to_midi_tpu.data import labels as jax_labels
from audio_to_midi_tpu.data import loader as jax_loader
from audio_to_midi_tpu.data import synthetic as jax_synthetic
from audio_to_midi_tpu.ops import eventize as jax_eventize
from audio_to_midi_tpu.ops import rasterize as jax_rasterize
from audio_to_midi_tpu_torch import config as pt_config
from audio_to_midi_tpu_torch.data import augment as pt_augment
from audio_to_midi_tpu_torch.data import labels as pt_labels
from audio_to_midi_tpu_torch.data import loader as pt_loader
from audio_to_midi_tpu_torch.data import synthetic as pt_synthetic
from audio_to_midi_tpu_torch.ops import eventize as pt_eventize
from audio_to_midi_tpu_torch.ops import rasterize as pt_rasterize
from tests.test_ops import _make_probs

torch.set_num_threads(2)

QUIRKY_CSV = ("% header\n0.0,0.0,21,0.0\n1.0, 0.5, 60, 0.73\n2.005, 0.001, 21, 1.0\n"
              "bad,row\n3.0,1e40,64,0.5\n0.5,0.25,-3,0.5\n0.25,0.25,70,nan\n"
              "0.5,0.5,60abc,0.5\n0.03,0.01,88,0.45\n\n% comment\n0.7,0.2,+72,0.8\n")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_data")
    pt_synthetic.make_synthetic_dataset(d, num_samples=5, duration_s=1.3, notes_per_sample=4,
                                        seed=3)
    return d


def _paths(monkeypatch, native: bool) -> None:
    if not native:
        monkeypatch.setattr(pt_loader, "_use_native", lambda: False)
        monkeypatch.setattr(jax_loader, "_use_native", lambda: False)


# --- labels --------------------------------------------------------------


def test_parse_and_write_events_csv(tmp_path):
    p = tmp_path / "l.csv"
    p.write_text(QUIRKY_CSV)
    for dpf in (0.02, 0.01, 1 / 3):
        events = pt_labels.parse_events_csv(p, dpf)
        assert events == jax_labels.parse_events_csv(p, dpf) and len(events) >= 5
    rows = [(0.5, 0.25, 60, 0.7), (1.25, 2.0, 21, 0.1)]
    for header in (True, False):
        pt_labels.write_events_csv(tmp_path / "a.csv", rows, header)
        jax_labels.write_events_csv(tmp_path / "b.csv", rows, header)
        assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()


# --- rasterize -----------------------------------------------------------


def test_rasterize_events_np():
    rng = np.random.default_rng(0)
    events = [(int(a), int(k), int(d), 7) for a, k, d in zip(
        rng.integers(-5, 60, 40), rng.integers(-2, 92, 40), rng.integers(1, 30, 40))]
    events.sort()
    for start, backing in ((0, None), (10, 45), (0, 3)):
        ours = pt_rasterize.rasterize_events_np(events, 50, start, backing)
        ref = jax_rasterize.rasterize_events_np(events, 50, start, backing)
        assert np.array_equal(ours, ref)
    assert [a.tolist() for a in pt_rasterize.to_frame_events([events[:5]], 30)] == \
        [a.tolist() for a in jax_rasterize.to_frame_events([events[:5]], 30)]


@pytest.mark.parametrize("seed,frames,keys", [(0, 120, 12), (1, 120, 12), (2, 250, 90),
                                              (3, 7, 5)])
def test_rasterize_dense_matches_jax(seed, frames, keys):
    probs = _make_probs(seed, frames, keys)
    ours = pt_rasterize.rasterize_dense(*pt_eventize.extract_events_dense(probs))
    ref = np.asarray(jax_rasterize.rasterize_dense(
        *jax_eventize.extract_events_dense(jnp.asarray(probs))))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-7)
    # and the sequential rasterizer of the event list; numpy's f32 exp is 2
    # ulps from torch's and XLA's near 1 (JAX's own test allows 1e-5)
    events = pt_eventize.extract_events(probs)
    np.testing.assert_allclose(ours.numpy(), pt_rasterize.rasterize_events_np(events, frames,
                                                                              num_keys=keys),
                               rtol=0, atol=2.5e-7)


# --- synthetic data ------------------------------------------------------


@pytest.mark.parametrize("kwargs", [{}, {"variety": True}, {"family": "mixed"}])
def test_synthetic_dataset_files_are_jaxs(tmp_path, kwargs):
    a = pt_synthetic.make_synthetic_dataset(tmp_path / "a", num_samples=2, duration_s=1.0,
                                            notes_per_sample=5, seed=4, **kwargs)
    b = jax_synthetic.make_synthetic_dataset(tmp_path / "b", num_samples=2, duration_s=1.0,
                                             notes_per_sample=5, seed=4, **kwargs)
    assert a == b
    files = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "b").iterdir()) and len(files) == 4
    for name in files:
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()


# --- host augmentation ----------------------------------------------------


@pytest.mark.parametrize("parity_pan", [False, True])
def test_host_augmentation_is_jaxs_under_one_seed(parity_pan):
    rng = np.random.default_rng(5)
    audio = rng.standard_normal((16, 2, 800)).astype(np.float32)
    audio[3, 1] = 0.0  # one single-channel item: pan leaves it
    labels = rng.random((16, 40, 90)).astype(np.float32)
    a1, l1, a2, l2 = audio.copy(), labels.copy(), audio.copy(), labels.copy()
    pt_augment.transform_for_training(
        a1, l1, pt_config.TransformSettings(parity_pan_uses_channel_switch_probability=parity_pan),
        np.random.default_rng(9))
    jax_augment.transform_for_training(
        a2, l2, jax_config.TransformSettings(
            parity_pan_uses_channel_switch_probability=parity_pan), np.random.default_rng(9))
    assert not np.array_equal(a1, audio)
    assert np.array_equal(a1, a2) and np.array_equal(l1, l2)


# --- loading ---------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False])
def test_load_events_and_audio(dataset, monkeypatch, native):
    _paths(monkeypatch, native)
    names = pt_loader.load_sample_names(dataset)
    assert names == jax_loader.load_sample_names(dataset)
    ours = pt_loader.load_events_and_audio(dataset, names, 16_000, 0.5, 50, skip_cache=True)
    ref = jax_loader.load_events_and_audio(dataset, names, 16_000, 0.5, 50, skip_cache=True)
    assert ours[2] == ref[2] and len(ours[2]) > len(names)
    for a, b in zip(ours[0] + ours[1], ref[0] + ref[1]):
        assert np.array_equal(a, b)
    settings_pt, settings_jax = pt_config.TransformSettings(), jax_config.TransformSettings()
    ours = pt_loader.load_events_and_audio_with_transformations(
        dataset, names, 16_000, 0.5, 50, settings_pt, skip_cache=True,
        rng=np.random.default_rng(1))
    ref = jax_loader.load_events_and_audio_with_transformations(
        dataset, names, 16_000, 0.5, 50, settings_jax, skip_cache=True,
        rng=np.random.default_rng(1))
    for a, b in zip(ours[0] + ours[1], ref[0] + ref[1]):
        assert np.array_equal(a, b)
    path = pt_loader.resolve_audio_file(dataset / names[0])
    assert np.array_equal(pt_loader.load_full_audio(path), jax_loader.load_full_audio(path))


@pytest.mark.parametrize("native,transforms", [(True, False), (True, True), (False, True)])
def test_threaded_batch_loader_is_jaxs(dataset, monkeypatch, native, transforms):
    _paths(monkeypatch, native)
    kwargs = dict(num_workers=1, seed=7, audio_duration=0.5, mini_batch_size=3)
    ours = pt_loader.ThreadedBatchLoader(
        dataset, 4, 50, pt_config.TransformSettings() if transforms else None, **kwargs)
    ref = jax_loader.ThreadedBatchLoader(
        dataset, 4, 50, jax_config.TransformSettings() if transforms else None, **kwargs)
    with ours, ref:
        for (e1, a1), (e2, a2), _ in zip(ours, ref, range(4)):
            assert a1.dtype == a2.dtype == np.float16 and a1.shape == (4, 2, 8000)
            assert np.array_equal(a1, a2) and np.array_equal(e1, e2)


def test_create_dataset_loader_builds_the_threaded_loader(dataset):
    loader = pt_loader.create_dataset_loader(dataset, batch_size=2, num_workers=0, num_epochs=3,
                                             duration=0.5, output_divisions=50, use_grain=False)
    assert isinstance(loader, pt_loader.ThreadedBatchLoader)
    with loader:
        batches = list(loader)
    assert batches and all(a.shape == (2, 2, 8000) and e.shape == (2, 50, 90)
                           for e, a in batches)


def test_the_data_harness_runs(tmp_path, capsys):
    from audio_to_midi_tpu_torch.data.__main__ import main

    pt_synthetic.make_synthetic_dataset(tmp_path, num_samples=2, duration_s=5.5,
                                        notes_per_sample=3, seed=2)
    assert main([str(tmp_path), "--batches", "2", "--batch-size", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("batch ") == 2 and "(2, 2, 80000)" in out


# --- config ----------------------------------------------------------------


def test_transforms_round_trip_with_jax_json():
    settings = dict(pan_probability=0.3, eq_probability=0.2,
                    parity_pan_uses_channel_switch_probability=True)
    jax_cfg = dataclasses.replace(jax_config.DEFAULT_CONFIG,
                                  transforms=jax_config.TransformSettings(**settings))
    port = pt_config.config_from_json(jax_config.config_to_json(jax_cfg))
    assert port.transforms == pt_config.TransformSettings(**settings)
    back = jax_config.config_from_json(pt_config.config_to_json(port))
    assert back.transforms == jax_cfg.transforms
    assert pt_config.TransformSettings().as_tuple() == jax_config.TransformSettings().as_tuple()
    assert port.metadata() == jax_cfg.metadata()
    off = dataclasses.replace(port, transforms=None)
    assert pt_config.config_from_json(pt_config.config_to_json(off)).transforms is None
