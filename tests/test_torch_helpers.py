"""The port's last public helpers against their JAX functions, on the CPU:
``models/rope.{apply_rope, permute_qk_weight_for_rope}``,
``config.config_from_metadata``,
``train/checkpoint.score_by_checkpoint_metrics``,
``data/audio_io.write_aiff`` and ``ops/frontend.{split_training_windows,
fft_audio}``.  Inputs are made with numpy from a seed and given to both
sides.  The host helpers are held exactly; ``fft_audio`` within 1e-5 of the
largest JAX magnitude (both take an f32 FFT, in their own orders), RoPE
within 1e-6 (an f32 rotation of O(1) values)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu.data import audio_io as jax_audio_io
from audio_to_midi_tpu.models import rope as jax_rope
from audio_to_midi_tpu.ops import frontend as jax_frontend
from audio_to_midi_tpu.train import checkpoint as jax_checkpoint
from audio_to_midi_tpu_torch import config as pt_config
from audio_to_midi_tpu_torch import models as pt_models
from audio_to_midi_tpu_torch.data import audio_io as pt_audio_io
from audio_to_midi_tpu_torch.models import rope as pt_rope
from audio_to_midi_tpu_torch.ops import frontend as pt_frontend
from audio_to_midi_tpu_torch.train import checkpoint as pt_checkpoint

torch.set_num_threads(2)

FFT_LIMIT = 1e-5
ROPE_ATOL = 1e-6


def test_models_exports_the_jax_names_the_port_has():
    from audio_to_midi_tpu import models as jax_models

    assert set(pt_models.__all__) == set(jax_models.__all__)
    for name in pt_models.__all__:
        assert getattr(pt_models, name) is not None
    assert pt_models.apply_rope is pt_rope.apply_rope
    assert pt_models.forward is pt_models.model.forward
    with pytest.raises(AttributeError):
        pt_models.no_such_name


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 250, 4, 64)).astype(np.float32)
    jax_freqs = jax_rope.precompute_frequencies(64, 300)
    pt_freqs = pt_rope.precompute_frequencies(64, 300)
    jdt, tdt = (jnp.float32, torch.float32) if dtype is np.float32 else (jnp.bfloat16,
                                                                          torch.bfloat16)
    want = np.asarray(jax_rope.apply_rope(jnp.asarray(x, jdt), jax_freqs).astype(jnp.float32))
    got = pt_rope.apply_rope(torch.from_numpy(x).to(tdt), pt_freqs)
    assert got.dtype == tdt and got.shape == x.shape
    atol = ROPE_ATOL if dtype is np.float32 else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_apply_rope_is_the_halves_rotation_after_the_weight_permutation():
    rng = np.random.default_rng(1)
    heads, hd, width, seq = 4, 16, 24, 37
    h = rng.standard_normal((seq, width)).astype(np.float32)
    w = rng.standard_normal((width, heads * hd)).astype(np.float32)
    permuted = pt_rope.permute_qk_weight_for_rope(w, heads)
    np.testing.assert_array_equal(permuted, np.asarray(jax_rope.permute_qk_weight_for_rope(w,
                                                                                           heads)))
    as_tensor = pt_rope.permute_qk_weight_for_rope(torch.from_numpy(w), heads)
    assert isinstance(as_tensor, torch.Tensor)
    np.testing.assert_array_equal(as_tensor.numpy(), permuted)

    freqs = pt_rope.precompute_frequencies(hd, 64)
    interleaved = pt_rope.apply_rope(torch.from_numpy(h @ w).reshape(seq, heads, hd), freqs)
    halves = pt_rope.apply_rope_halves(torch.from_numpy(h @ permuted).reshape(seq, heads, hd),
                                       freqs)
    perm = torch.from_numpy(pt_rope.rope_permutation(hd))
    torch.testing.assert_close(interleaved[..., perm], halves, rtol=0, atol=ROPE_ATOL)


def test_config_from_metadata_round_trips_as_in_jax():
    cases = [
        {},
        {"model": {"dims": [8, 16, 16, 32, 32, 64, 64], "depths": [1, 1, 1, 1, 1, 2, 1],
                   "num_transformer_layers": 2, "attention_size": 16,
                   "transformer_dropout_rate": 0.0, "sdd_rate": 0.25},
         "data": {"midi_vocab_size": 88, "model_audio_length": 2.5,
                  "num_velocity_categories": 4}},
    ]
    for case in cases:
        jax_cfg = jax_config.config_from_json(json.dumps(case))
        pt_cfg = pt_config.config_from_json(json.dumps(case))
        jax_back = jax_config.config_from_metadata(jax_cfg.metadata())
        pt_back = pt_config.config_from_metadata(pt_cfg.metadata())
        assert pt_cfg.metadata() == jax_cfg.metadata()
        assert (json.loads(pt_config.config_to_json(pt_back))
                == json.loads(jax_config.config_to_json(jax_back)))
        assert pt_back.model.dims == pt_cfg.model.dims
        assert pt_back.data.midi_vocab_size == pt_cfg.data.midi_vocab_size
    # Fields outside the metadata keep their defaults, as in JAX.
    edited = dataclasses.replace(pt_config.DEFAULT_CONFIG.model, attention_impl="xla")
    back = pt_config.config_from_metadata(
        dataclasses.replace(pt_config.DEFAULT_CONFIG, model=edited).metadata())
    assert back == pt_config.DEFAULT_CONFIG
    assert pt_config.config_from_metadata({}) == pt_config.DEFAULT_CONFIG


def test_score_by_checkpoint_metrics_matches_jax():
    rng = np.random.default_rng(2)
    for metrics in ({"a": 1.0, "b": 3.0},
                    {f"m{i}": float(v) for i, v in enumerate(rng.standard_normal(7))},
                    {"loss": np.float32(0.25), "hit": np.float64(0.5)}):
        got = pt_checkpoint.score_by_checkpoint_metrics(metrics)
        assert type(got) is float
        assert got == jax_checkpoint.score_by_checkpoint_metrics(metrics)


@pytest.mark.parametrize("channels,frames,rate", [(2, 4001, 16_000), (1, 10, 44_100),
                                                  (2, 0, 32_000)])
def test_write_aiff_writes_the_jax_bytes_and_reads_back(tmp_path, channels, frames, rate):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((channels, frames)) * 0.6).astype(np.float32)
    x[:, : frames // 7] *= 3  # some beyond [-1, 1], to be clipped
    pt_audio_io.write_aiff(tmp_path / "pt.aif", x, rate)
    jax_audio_io.write_aiff(tmp_path / "jax.aif", x, rate)
    data = (tmp_path / "pt.aif").read_bytes()
    assert data == (tmp_path / "jax.aif").read_bytes()
    back, got_rate = pt_audio_io._decode_aiff(data)
    assert got_rate == rate and back.shape == x.shape
    np.testing.assert_array_equal(back, np.trunc(np.clip(x, -1, 1) * 32767) / 32768.0)


def test_write_extended80_matches_jax_and_reads_back():
    for value in (0.0, 1.0, 8000.0, 16000.0, 22050.0, 44100.0, 48000.0, 96000.0, 0.1, 3.5e9):
        encoded = pt_audio_io._write_extended80(value)
        assert encoded == jax_audio_io._write_extended80(value)
        assert pt_audio_io._read_extended80(encoded) == value


def test_split_training_windows_matches_jax():
    rng = np.random.default_rng(4)
    window = 100
    for n in (1, 49, 50, 51, 100, 150, 151, 250, 999):
        x = rng.standard_normal((2, n)).astype(np.float32)
        got = pt_frontend.split_training_windows(x, window)
        want = jax_frontend.split_training_windows(x, window)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[1].dtype == np.bool_ and got[2].sum() == n


@pytest.mark.parametrize("shape,window,overlap", [((2, 4000), 256, 0.5), ((3000,), 512, 0.75),
                                                  ((2, 1000), 128, 0.0)])
def test_fft_audio_matches_jax(shape, window, overlap):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_frontend.fft_audio(jnp.asarray(x), window, overlap))
    got = pt_frontend.fft_audio(torch.from_numpy(x), window, overlap)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= FFT_LIMIT


def test_fft_audio_refuses_a_window_that_is_not_a_power_of_two():
    x = np.zeros(1000, np.float32)
    with pytest.raises(ValueError, match="power of 2") as want:
        jax_frontend.fft_audio(jnp.asarray(x), 300)
    with pytest.raises(ValueError, match="power of 2") as got:
        pt_frontend.fft_audio(torch.from_numpy(x), 300)
    assert str(got.value) == str(want.value)
    assert pt_frontend.fft_audio(torch.from_numpy(x[:100]), 128).shape == (65, 0)
    assert jax_frontend.fft_audio(jnp.asarray(x[:100]), 128).shape == (65, 0)
