"""The rest of the port's serving path vs the JAX package, on the CPU:
chunked stitching, the polyphase resampler, the fused in-memory path,
streaming transcription, the model's frame probe and the CLI's --stream.

Tolerances:
  * stitch_chunk: bit for bit the rows of the port's batch and sequential
    stitchers (the same float32 blend on the same rows, at integral and
    non-integral overlap frames); against JAX's stitch_chunk within 1e-6
    (XLA may contract the blend into an FMA), as test_stitch_matches_jax;
  * resample_poly: within 1e-6 of the signal's largest magnitude -- 16
    products per output summed in another order than XLA's convolution
    (read: <= 3.6e-7 on these inputs);
  * transcription: stitched probabilities within atol 1e-5 of JAX's (f32
    model, sums in another order, as test_transcribe_file_matches_jax), and
    within 1e-6 between the port's streaming and batch paths (the same
    arithmetic, the model at another batch); events identical, with no
    probability within those limits of a threshold.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu import infer as jax_infer
from audio_to_midi_tpu.models import model as jax_model
from audio_to_midi_tpu.ops import frontend as jax_frontend
from audio_to_midi_tpu.ops import stitch as jax_stitch
from audio_to_midi_tpu_torch import config as pt_config
from audio_to_midi_tpu_torch import infer as pt_infer
from audio_to_midi_tpu_torch.models import model as pt_model
from audio_to_midi_tpu_torch.ops import frontend as pt_frontend
from audio_to_midi_tpu_torch.ops import midi_io as pt_midi_io
from audio_to_midi_tpu_torch.ops import stitch as pt_stitch
from tests.test_torch_primitives import SMALL_CFG, SMALL_JAX_CFG, port_model
from tests.test_torch_serving import THRESHOLDS, _unflatten, slice_files  # noqa: F401

torch.set_num_threads(2)

JAX_CFG = jax_config.Config(model=SMALL_JAX_CFG)


def _jax_params(flat: dict) -> dict:
    return _unflatten({k: jnp.asarray(v) for k, v in flat.items()})


def _chunked(probs: np.ndarray, overlap: float, dpf: float, chunk: int, stitch, as_input,
             **fixed) -> tuple[np.ndarray, int]:
    """Stitch ``probs`` chunk by chunk with ``stitch`` (the port's or JAX's
    stitch_chunk); returns the emitted rows and the output's frames."""
    windows, fpw, keys = probs.shape
    d, own, frames, ov = pt_stitch.stitch_chunk_plan(windows, fpw, overlap, dpf)
    segs, prev = [], np.zeros((fpw, keys), np.float32)
    for w0 in range(0, windows, chunk):
        part = probs[w0 : w0 + chunk]
        wc = part.shape[0]
        segs.append(np.asarray(stitch(
            as_input(prev), as_input(part), d=fixed["cast"](d[w0 : w0 + wc]),
            own=fixed["cast"](own[w0 : w0 + wc]), ov=ov, first=w0 == 0)))
        prev = part[-1]
    return np.concatenate(segs), frames


# (overlap s, s per frame): 10 overlap frames, 10.03, none.
@pytest.mark.parametrize("overlap,dpf", [(0.1, 0.01), (0.1003, 0.01), (0.0, 0.01)])
@pytest.mark.parametrize("fpw,chunk", [(50, 4), (250, 3)])
def test_stitch_chunk_matches_batch_and_jax(overlap, dpf, fpw, chunk):
    probs = np.random.default_rng(fpw).random((11, fpw, 7)).astype(np.float32)
    batch = pt_stitch.stitch_probs_parallel(torch.from_numpy(probs), overlap, dpf).numpy()
    # The batch stitcher is one chunk; the sequential loop writes the same rows.
    sequential = pt_stitch.stitch_probs(torch.from_numpy(probs), overlap, dpf).numpy()
    np.testing.assert_array_equal(batch, sequential)
    rows, frames = _chunked(probs, overlap, dpf, chunk, pt_stitch.stitch_chunk,
                            torch.from_numpy, cast=list)
    assert frames == batch.shape[0] and rows.shape[0] <= frames
    np.testing.assert_array_equal(rows, batch[: rows.shape[0]])
    assert not batch[rows.shape[0]:].any()  # the zero tail the batch stitcher leaves
    ref, _ = _chunked(probs, overlap, dpf, chunk, jax_stitch.stitch_chunk, jnp.asarray,
                      cast=lambda a: tuple(int(x) for x in a))
    np.testing.assert_allclose(rows, ref, rtol=0, atol=1e-6)


def test_stitch_chunk_plan_matches_jax():
    for args in [(11, 50, 0.1, 0.01), (11, 50, 0.1003, 0.01), (7, 250, 0.5, 0.02),
                 (1, 250, 0.5, 0.02)]:
        out, ref = pt_stitch.stitch_chunk_plan(*args), jax_stitch.stitch_chunk_plan(*args)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
    for plan in (pt_stitch.stitch_chunk_plan, jax_stitch.stitch_chunk_plan):
        with pytest.raises(ValueError):  # stride 320 <= ceil(480): chained blends
            plan(4, 25, 0.3, 0.02)


def _jax_resample(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """JAX's resample_poly channel by channel.  Given both channels at once,
    at an input length that is a multiple of the reduced ``down`` (441 for
    44.1 kHz -> 16 kHz: every whole second), XLA's CPU convolution returns
    another second channel than it returns for that channel alone (off by up
    to ~1 on unit-variance noise); one channel at a time it is right."""
    return np.concatenate([np.asarray(jax_frontend.resample_poly(jnp.asarray(c[None]), up, down))
                           for c in x])


def _tones(seconds: float, rate: int, seed: int) -> np.ndarray:
    """(2, seconds * rate) float32 stereo decaying tones, one every 0.5 s."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    x = np.zeros((2, t.size))
    for start in np.arange(0.0, seconds - 0.5, 0.5):
        since = np.maximum(t - start, 0.0)
        tone = np.where(t >= start, np.exp(-3 * since), 0.0) * np.sin(
            2 * np.pi * 440.0 * 2 ** (rng.integers(-24, 24) / 12) * since)
        pan = rng.uniform(0.3, 0.7)
        x += np.stack([pan * tone, (1 - pan) * tone])
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


# (source rate, input samples): half a second and a few samples, and whole
# seconds (a multiple of the reduced down factor).
@pytest.mark.parametrize("src_rate,n", [(44_100, 22_087), (44_100, 88_200), (48_000, 24_037),
                                        (22_050, 11_062), (8_000, 8_000), (8_000, 4_037)])
def test_resample_poly_matches_jax(src_rate, n):
    x = (np.random.default_rng(src_rate + n).standard_normal((2, n)) * 0.3).astype(np.float32)
    ref = _jax_resample(x, 16_000, src_rate)
    out = pt_frontend.resample_poly(torch.from_numpy(x), 16_000, src_rate)
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, -(-n * 16_000 // src_rate))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_kaiser_filter_and_prepare_windows_match_jax():
    np.testing.assert_array_equal(pt_frontend._kaiser_sinc_filter(16 * 160, 0.5 / 441),
                                  jax_frontend._kaiser_sinc_filter(16 * 160, 0.5 / 441))
    x = (np.random.default_rng(5).standard_normal((2, 30_000)) * 0.2).astype(np.float32)
    for src in (44_100, 16_000):
        ref = np.asarray(jax_frontend.prepare_windows(jnp.asarray(x), src, 16_000, 8000, 800))
        out = pt_frontend.prepare_windows(torch.from_numpy(x), src, 16_000, 8000, 800).numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_compute_model_output_frames_matches_the_config(slice_files):
    _, flat = slice_files
    model = port_model(flat)
    for n in (80_000, 16_000, 4096):
        assert pt_model.compute_model_output_frames(model, SMALL_CFG.model, n) == \
            SMALL_CFG.model.output_frames(n)
    # The einsum attention route: the frame count does not depend on the route.
    xla = dataclasses.replace(SMALL_JAX_CFG, attention_impl="xla")
    assert jax_model.compute_model_output_frames(_jax_params(flat), xla, 4096) == 12


def test_predict_matches_forward(slice_files):
    model = port_model(slice_files[1])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 16_000)).astype(np.float32))
    rope = pt_model.make_rope(SMALL_CFG.model)
    logits, probs = pt_model.predict(model, SMALL_CFG.model, x, rope)
    ref_logits, ref_probs = pt_model.forward(model, SMALL_CFG.model, x[None], rope)
    assert torch.equal(logits, ref_logits[0]) and torch.equal(probs, ref_probs[0])


def test_transcribe_samples_fused_matches_jax(slice_files):
    """6 s of 44.1 kHz stereo in memory: the port's resampler, normalization,
    windows, model and stitch on the model's device, compute in f32, against
    JAX's transcribe_samples_fused composed from its own pieces -- JAX's
    resampler channel by channel (see _jax_resample: at whole seconds its
    two-channel call is wrong on the CPU), then its prepare_windows
    remainder and predict_and_stitch_fused."""
    _, flat = slice_files
    audio = _tones(6.0, 44_100, seed=7)
    cfg = dataclasses.replace(SMALL_CFG, precision=pt_config.PrecisionConfig("f32", "f32"))
    model = port_model(flat)
    out = pt_infer.transcribe_samples_fused(
        model, cfg, torch.from_numpy(audio), pt_model.make_rope(cfg.model), src_rate=44_100,
        window_duration=5.0, overlap=0.5)
    windows = jax_frontend.make_windows(
        jax_frontend.normalize_loudness(jnp.asarray(_jax_resample(audio, 16_000, 44_100))),
        80_000, 8_000)
    ref = np.asarray(jax_infer.predict_and_stitch_fused(
        _jax_params(flat), SMALL_JAX_CFG, windows, jax_model.make_rope(SMALL_JAX_CFG), 5.0, 0.5))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (
        2 * 250 - 25, SMALL_CFG.model.output_vocab)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    # A bf16 compute dtype runs a cast copy and leaves the model in f32.
    bf16 = pt_infer.transcribe_samples_fused(
        model, SMALL_CFG, torch.from_numpy(audio), pt_model.make_rope(cfg.model),
        src_rate=44_100, window_duration=5.0, overlap=0.5)
    assert next(model.parameters()).dtype == torch.float32
    assert bf16.dtype == torch.float32 and bf16.shape == out.shape
    assert np.abs(bf16.numpy() - ref).max() < 0.1


def test_predict_and_stitch_fused_matches_predict_and_stitch(slice_files):
    root, flat = slice_files
    model = port_model(flat)
    windows = torch.from_numpy(
        np.random.default_rng(3).standard_normal((3, 2, 80_000)).astype(np.float32))
    rope = pt_model.make_rope(SMALL_CFG.model)
    _, stitched, _ = pt_infer.predict_and_stitch(model, SMALL_CFG, windows, 5.0, 0.5, rope)
    fused = pt_infer.predict_and_stitch_fused(model, SMALL_CFG.model, windows, rope, 5.0, 0.5)
    np.testing.assert_array_equal(fused.numpy(), stitched)
    two = pt_infer.predict_and_stitch_fused(model, SMALL_CFG.model, windows, rope, 5.0, 0.5,
                                            valid_windows=2)
    _, stitched_two, _ = pt_infer.predict_and_stitch(model, SMALL_CFG, windows[:2], 5.0, 0.5,
                                                     rope)
    assert two.shape == stitched_two.shape == (2 * 250 - 25, SMALL_CFG.model.output_vocab)
    np.testing.assert_allclose(two.numpy(), stitched_two, rtol=0, atol=1e-6)


def test_streaming_matches_batch_and_jax(slice_files):
    """12 s at overlap 0.5: 3 windows, one per chunk."""
    root, flat = slice_files
    path = root / "song.wav"
    model = pt_infer.load_params(root / "params.npz", SMALL_CFG, "cpu", torch.float32)
    batch, dpf_b, events_b = pt_infer.transcribe_file(model, SMALL_CFG, path, overlap=0.5)

    stages, segments = {}, []
    stitched, dpf, events = pt_infer.transcribe_file_streaming(
        model, SMALL_CFG, path, overlap=0.5, chunk_windows=1, stage_times=stages,
        on_segment=lambda w0, seg: segments.append((w0, seg.shape[0])))
    assert [w0 for w0, _ in segments] == [0, 1, 2]
    assert sum(rows for _, rows in segments) <= stitched.shape[0] == batch.shape[0] == 700
    assert dpf == dpf_b == 5.0 / SMALL_CFG.model.output_frames(80_000)
    np.testing.assert_allclose(stitched, batch, rtol=0, atol=1e-6)
    assert len(events) > 100 and events == events_b
    assert {"decode", "first_segment_s", "first_event_s", "total_s"} <= set(stages)
    assert 0 < stages["first_segment_s"] <= stages["total_s"]

    ref, ref_dpf, ref_events = jax_infer.transcribe_file_streaming(
        _jax_params(flat), JAX_CFG, path, overlap=0.5, chunk_windows=1)
    assert dpf == ref_dpf
    np.testing.assert_allclose(stitched, ref, rtol=0, atol=1e-5)
    near = min(float(np.abs(ref - t).min()) for t in THRESHOLDS)
    assert near > 1e-5, f"a probability lies {near:.1e} from a threshold: pick another seed"
    assert events == ref_events

    none, _, same = pt_infer.transcribe_file_streaming(
        model, SMALL_CFG, path, overlap=0.5, chunk_windows=2, fetch_stitched=False)
    assert none is None and same == events


def test_streaming_overlap_fallback_is_the_batch_path(slice_files, caplog):
    """Overlap 3 s of a 5 s window: the stride (2 s) is under the blend
    width, so streaming runs the batch path, as the JAX package does."""
    root, _ = slice_files
    model = pt_infer.load_params(root / "params.npz", SMALL_CFG, "cpu", torch.float32)
    with caplog.at_level("INFO", logger="audio_to_midi_tpu_torch.infer"):
        stitched, dpf, events = pt_infer.transcribe_file_streaming(
            model, SMALL_CFG, root / "song.wav", overlap=3.0, chunk_windows=1)
    assert "using batch path" in caplog.text
    ref, ref_dpf, ref_events = pt_infer.transcribe_file(model, SMALL_CFG, root / "song.wav",
                                                        overlap=3.0)
    np.testing.assert_array_equal(stitched, ref)
    assert dpf == ref_dpf and events == ref_events


def test_transcribe_file_stage_times(slice_files):
    root, _ = slice_files
    model = pt_infer.load_params(root / "params.npz", SMALL_CFG, "cpu", torch.float32)
    stages = {}
    none, _, events = pt_infer.transcribe_file(model, SMALL_CFG, root / "song.wav",
                                               stage_times=stages, fetch_stitched=False)
    assert none is None and len(events) > 100
    assert list(stages) == ["decode", "transfer", "window", "model_stitch", "eventize", "fetch"]
    assert all(t >= 0 for t in stages.values())


def test_cli_stream_writes_the_batch_midi(slice_files, tmp_path, capsys):
    from audio_to_midi_tpu_torch.cli.audio_to_midi import main

    root, _ = slice_files
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(pt_config.config_to_json(SMALL_CFG))
    args = [str(root / "song.wav"), "--checkpoint", str(root / "params.npz"),
            "--config", str(cfg_path), "--device", "cpu"]
    assert main([args[0], str(tmp_path / "batch.mid"), *args[1:]]) == 0
    assert main([args[0], str(tmp_path / "stream.mid"), *args[1:], "--stream"]) == 0
    assert "Stitched probs shape: (700, 90)" in capsys.readouterr().out
    assert (tmp_path / "stream.mid").read_bytes() == (tmp_path / "batch.mid").read_bytes()
    assert len(pt_midi_io.read_midi_file(tmp_path / "stream.mid")) > 100
