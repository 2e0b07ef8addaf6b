"""``modelutil.py`` (the reference plugin's surface) against the JAX
package's ``modelutil`` on the same files and arrays, with the native plane
on and off, as ``tests/test_compat.py`` exercises JAX's; and
``ops.frontend.slice_full_audio`` against JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import modelutil as jax_modelutil
from audio_to_midi_tpu import native as jax_native
from audio_to_midi_tpu.ops import frontend as jax_frontend
from audio_to_midi_tpu_torch import modelutil, native
from audio_to_midi_tpu_torch.config import MODEL_AUDIO_LENGTH, SAMPLE_RATE
from audio_to_midi_tpu_torch.data import synthetic
from audio_to_midi_tpu_torch.data.loader import resolve_audio_file
from audio_to_midi_tpu_torch.ops import slice_full_audio

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("modelutil_dataset")
    names = synthetic.make_synthetic_dataset(d, num_samples=2, duration_s=6.0, seed=21)
    return d, names


@pytest.fixture(params=["native", "numpy"])
def plane(request, monkeypatch):
    """Both packages on the native plane, or both on their numpy paths."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    else:
        assert native.available() and jax_native.available()
    return request.param


def test_load_full_audio(dataset, plane):
    d, names = dataset
    f = str(resolve_audio_file(d / names[0]))
    ours, ref = modelutil.load_full_audio(f, SAMPLE_RATE), jax_modelutil.load_full_audio(
        f, SAMPLE_RATE)
    assert ours.dtype == np.float32 and ours.shape[0] == 2
    np.testing.assert_array_equal(ours, ref)


def test_load_events_and_audio(dataset, plane):
    d, names = dataset
    ours = modelutil.load_events_and_audio(str(d), names, SAMPLE_RATE, MODEL_AUDIO_LENGTH, 250,
                                           skip_cache=True)
    ref = jax_modelutil.load_events_and_audio(str(d), names, SAMPLE_RATE, MODEL_AUDIO_LENGTH,
                                              250, skip_cache=True)
    assert ours[2] == ref[2] and ours[2][0].endswith("+0")
    for mine, theirs in zip(ours[0] + ours[1], ref[0] + ref[1]):
        np.testing.assert_array_equal(mine, theirs)


def test_load_events_and_audio_with_transformations(dataset, plane, monkeypatch):
    """The reference's settings class (sic), the same draws on both sides."""
    d, names = dataset
    fields = dict(pan_probability=0.8, channel_switch_probability=0.5, cut_probability=0.4,
                  rotate_probability=0.9, random_erasing_probability=0.3,
                  mixup_probability=0.6, gain_probability=0.8, noise_probability=0.8,
                  label_smoothing_alpha=0.005)
    seeded = np.random.default_rng
    out = []
    for mu in (modelutil, jax_modelutil):
        monkeypatch.setattr(np.random, "default_rng", lambda seed=None: seeded(7))
        out.append(mu.load_events_and_audio_with_transformations(
            str(d), names, SAMPLE_RATE, MODEL_AUDIO_LENGTH, 250,
            mu.DatasetTransfromSettings(**fields), skip_cache=True))
    ours, ref = out
    assert ours[2] == ref[2]
    assert ours[1][0].min() >= 0.005 - 1e-6
    for mine, theirs in zip(ours[0] + ours[1], ref[0] + ref[1]):
        np.testing.assert_array_equal(mine, theirs)


def test_stitch_extract_to_frame(plane):
    rng = np.random.default_rng(0)
    probs = rng.random((3, 50, 90)).astype(np.float32) * 0.3
    probs[0, 10:30, 40] = 0.9
    probs[2, 5:45, 12] = 0.8
    stitched = modelutil.stitch_probs(probs, 0.2, 0.02)
    ref = jax_modelutil.stitch_probs(probs, 0.2, 0.02)
    assert stitched.dtype == np.float32 and stitched.shape[1] == 90
    np.testing.assert_allclose(stitched, ref, rtol=0, atol=1e-6)
    events = modelutil.extract_events(stitched)
    assert events == jax_modelutil.extract_events(stitched)
    assert any(e[1] == 40 for e in events) and all(isinstance(e, tuple) for e in events)
    frames = modelutil.to_frame_events([events, events[:1]], stitched.shape[0])
    refs = jax_modelutil.to_frame_events([events, events[:1]], stitched.shape[0])
    assert [f.shape for f in frames] == [(stitched.shape[0], 90)] * 2
    for mine, theirs in zip(frames, refs):
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("n,overlap", [(80_000, 0.5), (123_457, 0.5), (30_000, 0.25), (7, 0.0)])
def test_slice_full_audio_matches_jax(n, overlap):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    windows, duration = slice_full_audio(torch.from_numpy(x), SAMPLE_RATE, MODEL_AUDIO_LENGTH,
                                         overlap)
    ref, ref_duration = jax_frontend.slice_full_audio(jnp.asarray(x), SAMPLE_RATE,
                                                      MODEL_AUDIO_LENGTH, overlap)
    assert duration == ref_duration == MODEL_AUDIO_LENGTH
    np.testing.assert_array_equal(windows.numpy(), np.asarray(ref))
