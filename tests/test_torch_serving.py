"""The port's host and serving ops, and the whole file -> MIDI slice, vs the
JAX package on identical numpy inputs.

Tolerances: stitching within 1e-6 (the same f32 blend arithmetic, possibly
contracted to FMAs on one side); events and MIDI bytes identical; decoded
audio identical; the slice's stitched probabilities within atol 1e-5 (f32
model, sums in another order) with identical events.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_midi_tpu import config as jax_config
from audio_to_midi_tpu import infer as jax_infer
from audio_to_midi_tpu.data import audio_io as jax_audio_io
from audio_to_midi_tpu.data import loader as jax_loader
from audio_to_midi_tpu.ops import eventize as jax_eventize
from audio_to_midi_tpu.ops import frontend as jax_frontend
from audio_to_midi_tpu.ops import midi_io as jax_midi_io
from audio_to_midi_tpu.ops import stitch as jax_stitch
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch import infer as pt_infer
from audio_to_midi_tpu_torch.data import audio_io as pt_audio_io
from audio_to_midi_tpu_torch.ops import eventize as pt_eventize
from audio_to_midi_tpu_torch.ops import frontend as pt_frontend
from audio_to_midi_tpu_torch.ops import midi_io as pt_midi_io
from audio_to_midi_tpu_torch.ops import stitch as pt_stitch
from tests.test_torch_primitives import SMALL_CFG, SMALL_JAX_CFG, jax_params

torch.set_num_threads(2)

THRESHOLDS = (0.1, 0.4, 0.5)


def smooth_probs(seed: int, frames: int, keys: int = 90) -> np.ndarray:
    """Random-walk probabilities that cross every eventizer threshold."""
    rng = np.random.default_rng(seed)
    logits = np.cumsum(rng.standard_normal((frames, keys)) * 0.8, axis=0)
    logits -= logits.mean(0)
    return (1.0 / (1.0 + np.exp(-logits))).astype(np.float32)


# --- frontend -------------------------------------------------------------


@pytest.mark.parametrize("n,overlap", [(192_000, 8000), (80_000, 8000), (1000, 4000),
                                       (200_000, 0)])
def test_make_windows_matches_jax(n, overlap):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    ref = jax_frontend.make_windows(jnp.asarray(x), 80_000, overlap)
    out = pt_frontend.make_windows(torch.from_numpy(x), 80_000, overlap)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("gain", [1.0, 0.01])
def test_normalize_loudness_matches_jax(gain):
    x = (np.random.default_rng(1).standard_normal((2, 5000)) * 0.02 * gain).astype(np.float32)
    x[0, 7] = 0.5 * gain  # peak above (or, scaled, below) the 0.05 guard
    ref = jax_frontend.normalize_loudness(jnp.asarray(x))
    out = pt_frontend.normalize_loudness(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=0)


# --- stitching ------------------------------------------------------------


# (windows, overlap s): integral and non-integral overlap frames, one
# window, and an overlap past half a window (the sequential fallback).
@pytest.mark.parametrize("windows,overlap", [(7, 0.5), (5, 0.25), (1, 0.5), (4, 0.0),
                                             (4, 2.6)])
def test_stitch_matches_jax(windows, overlap):
    probs = np.random.default_rng(windows).random((windows, 250, 90)).astype(np.float32)
    dpf = 5.0 / 250
    ref_par = jax_stitch.stitch_probs_parallel(jnp.asarray(probs), overlap, dpf)
    ref_seq = jax_stitch.stitch_probs(jnp.asarray(probs), overlap, dpf)
    out_par = pt_stitch.stitch_probs_parallel(torch.from_numpy(probs), overlap, dpf)
    out_seq = pt_stitch.stitch_probs(torch.from_numpy(probs), overlap, dpf)
    assert out_par.shape == ref_par.shape
    np.testing.assert_allclose(out_par.numpy(), np.asarray(ref_par), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out_seq.numpy(), np.asarray(ref_seq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out_par.numpy(), out_seq.numpy(), rtol=0, atol=1e-6)


def test_stitch_plan_matches_jax():
    for args in [(7, 250, 0.5, 0.02), (5, 250, 0.25, 0.02), (9, 250, 0.33, 0.02)]:
        bases, frames, ov = pt_stitch.stitch_plan(*args)
        ref_bases, ref_frames, ref_ov = jax_stitch.stitch_plan(*args)
        np.testing.assert_array_equal(bases, ref_bases)
        assert (frames, ov) == (ref_frames, ref_ov)


# --- eventizer and MIDI ---------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eventize_matches_jax(seed):
    probs = smooth_probs(seed, 700)
    ref = jax_eventize.extract_events(jnp.asarray(probs))
    out = pt_eventize.extract_events(probs)
    assert len(out) > 50
    assert out == ref


def test_eventize_edge_cases_match_jax():
    probs = np.zeros((40, 3), np.float32)
    probs[0:, 0] = 0.9                       # active to the end
    probs[5:20, 1] = 0.6                     # attack, then release
    probs[10:40, 2] = np.linspace(0.45, 1.0, 30)
    probs[25:31, 2] = [0.3, 0.95, 0.97, 0.99, 0.98, 0.96]  # rising edge: re-activation
    assert pt_eventize.extract_events(probs) == jax_eventize.extract_events(jnp.asarray(probs))
    # Fewer frames than the 6-frame edge window: the JAX eventizer fails to
    # trace there (its shifted copies do not broadcast); the port returns
    # what the state machine gives.
    one = np.full((1, 90), 0.9, np.float32)
    assert pt_eventize.extract_events(one) == [(0, k, 1, 7) for k in range(90)]


def test_write_midi_matches_jax_bytes(tmp_path):
    events = pt_eventize.extract_events(smooth_probs(3, 500))
    pt_midi_io.write_midi_file(events, 0.02, tmp_path / "port.mid")
    jax_midi_io.write_midi_file(events, 0.02, tmp_path / "jax.mid")
    data = (tmp_path / "port.mid").read_bytes()
    assert data == (tmp_path / "jax.mid").read_bytes()
    back = pt_midi_io.read_midi_file(tmp_path / "port.mid")
    assert back == jax_midi_io.read_midi_file(tmp_path / "jax.mid")
    assert sum(1 for e in back if e[1] == "note_on") == len(events)


# --- decode ---------------------------------------------------------------


@pytest.mark.parametrize("channels,rate", [(2, 16_000), (1, 16_000), (2, 44_100)])
def test_wav_decode_matches_jax(tmp_path, monkeypatch, channels, rate):
    rng = np.random.default_rng(channels * rate)
    x = (rng.standard_normal((channels, rate * 2)) * 0.2).astype(np.float32)
    path = tmp_path / "a.wav"
    pt_audio_io.write_wav(path, x, rate)
    jax_audio_io.write_wav(tmp_path / "b.wav", x, rate)
    assert path.read_bytes() == (tmp_path / "b.wav").read_bytes()
    out = pt_audio_io.load_full_audio_f16(path, 16_000)
    if rate != 16_000:
        # The JAX package's C++ decode plane resamples with its own filter;
        # the port carries over its numpy/scipy chain, so compare with that.
        monkeypatch.setattr(jax_loader, "_use_native", lambda: False)
    ref = jax_loader.load_full_audio_f16(path, 16_000)
    assert out.dtype == ref.dtype == np.float16
    np.testing.assert_array_equal(out, ref)


def test_decode_rejects_unknown_formats(tmp_path):
    path = tmp_path / "a.mp3"
    path.write_bytes(b"\x00" * 64)
    with pytest.raises(pt_audio_io.AudioDecodeError):
        pt_audio_io.load_full_audio_f16(path)


# --- the slice: file -> stitched probabilities -> events ------------------


def _slice_params() -> dict[str, np.ndarray]:
    """Seeded params whose decoder saturates 80 of the 90 keys far from
    every threshold and leaves every 9th key live, so that events exist and
    no probability sits within the tolerance of a threshold."""
    flat = dict(jax_params(0))
    dead = np.ones(90, bool)
    dead[::9] = False
    w, b = flat["decoder/out/w"].copy(), flat["decoder/out/b"].copy()
    w[:, dead] = 0.0
    w *= 4.0
    b[dead] = np.where(np.arange(90)[dead] % 2 == 0, 6.0, -6.0)
    flat["decoder/out/w"], flat["decoder/out/b"] = w, b
    return flat


def _synth_wav(path, seconds: float, seed: int) -> None:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16_000)) / 16_000
    x = np.zeros((2, t.size))
    for start in np.arange(0.0, seconds - 1.0, 0.5):
        freq = 440.0 * 2 ** ((int(rng.integers(30, 70)) - 48) / 12)
        since = np.maximum(t - start, 0.0)
        tone = np.where(t >= start, np.exp(-since * 3.0), 0.0) * np.sin(2 * np.pi * freq * since)
        pan = rng.uniform(0.3, 0.7)
        x[0] += pan * tone
        x[1] += (1 - pan) * tone
    pt_audio_io.write_wav(path, (0.5 * x / np.abs(x).max()).astype(np.float32), 16_000)


@pytest.fixture(scope="module")
def slice_files(tmp_path_factory):
    """A seeded 12 s stereo WAV and the slice params as a port checkpoint."""
    root = tmp_path_factory.mktemp("slice")
    _synth_wav(root / "song.wav", 12.0, seed=3)
    flat = _slice_params()
    convert.save_npz(root / "params.npz", flat)
    return root, flat


def test_transcribe_file_matches_jax(slice_files):
    root, flat = slice_files
    path = root / "song.wav"
    model = pt_infer.load_params(root / "params.npz", SMALL_CFG, "cpu", torch.float32)
    stitched, dpf, events = pt_infer.transcribe_file(model, SMALL_CFG, path, overlap=0.5)

    jax_cfg = jax_config.Config(model=SMALL_JAX_CFG)
    params = _unflatten({k: jnp.asarray(v) for k, v in flat.items()})
    ref, ref_dpf, ref_events = jax_infer.transcribe_file(params, jax_cfg, path, overlap=0.5)

    assert stitched.shape == ref.shape == (700, 90)
    assert dpf == ref_dpf
    np.testing.assert_allclose(stitched, ref, rtol=0, atol=1e-5)
    near = min(float(np.abs(ref - t).min()) for t in THRESHOLDS)
    assert near > 1e-5, f"a probability lies {near:.1e} from a threshold: pick another seed"
    assert len(events) > 100
    assert events == ref_events

    # predict_and_stitch on the first two windows, against JAX's.
    windows = pt_frontend.make_windows(
        torch.from_numpy(pt_audio_io.load_full_audio_f16(path).astype(np.float32)),
        80_000, 8000)[:2].numpy()
    probs, st, dpf2 = pt_infer.predict_and_stitch(model, SMALL_CFG, windows, 5.0, overlap=0.5)
    ref_probs, ref_st, ref_dpf2 = jax_infer.predict_and_stitch(
        params, jax_cfg, windows, 5.0, overlap=0.5)
    assert dpf2 == ref_dpf2
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-5)
    np.testing.assert_allclose(st, ref_st, rtol=0, atol=1e-5)


def test_cli_writes_the_midi_of_transcribe_file(slice_files, tmp_path, capsys):
    from audio_to_midi_tpu_torch import config as pt_config
    from audio_to_midi_tpu_torch.cli.audio_to_midi import main

    root, _ = slice_files
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(pt_config.config_to_json(SMALL_CFG))
    out = tmp_path / "out.mid"
    assert main([str(root / "song.wav"), str(out), "--checkpoint", str(root / "params.npz"),
                 "--config", str(cfg_path), "--device", "cpu"]) == 0
    assert "Stitched probs shape: (700, 90)" in capsys.readouterr().out

    # The same model saved as a .pt state_dict loads to the same result.
    model = pt_infer.load_params(root / "params.npz", SMALL_CFG, "cpu")
    torch.save(model.state_dict(), tmp_path / "params.pt")
    model_pt = pt_infer.load_params(tmp_path / "params.pt", SMALL_CFG, "cpu")
    _, dpf, events = pt_infer.transcribe_file(model_pt, SMALL_CFG, root / "song.wav")
    pt_midi_io.write_midi_file(events, dpf, tmp_path / "ref.mid")
    assert out.read_bytes() == (tmp_path / "ref.mid").read_bytes()


def test_cli_needs_cuda_unless_told_cpu(slice_files, tmp_path):
    from audio_to_midi_tpu_torch.cli.audio_to_midi import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, _ = slice_files
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([str(root / "song.wav"), str(tmp_path / "o.mid"),
              "--checkpoint", str(root / "params.npz")])


def _unflatten(flat: dict) -> dict:
    """{"cnn/stages/0/down/conv/w": a} -> nested dicts, with list-valued
    ``stages`` as in ``models/model.init``."""
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    stages = tree["cnn"]["stages"]
    tree["cnn"]["stages"] = [stages[str(i)] for i in range(len(stages))]
    return tree
