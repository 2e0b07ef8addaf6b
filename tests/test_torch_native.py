"""The port's binding of the C++ data plane (audio_to_midi_tpu_torch/native.py)
against the JAX package's binding of the same sources: each of the eleven
functions on the same inputs, bit for bit; A2M_DISABLE_NATIVE; two processes
that build at once; a failed build."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_to_midi_tpu import native as jax_native
from audio_to_midi_tpu.config import TransformSettings as JaxTransformSettings
from audio_to_midi_tpu_torch import native
from audio_to_midi_tpu_torch.config import SAMPLE_RATE, TransformSettings
from audio_to_midi_tpu_torch.data import audio_io, synthetic

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(
    not (native.available() and jax_native.available()), reason="native library unavailable")


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_native")
    events = synthetic.random_events(2.0, 6, seed=11)
    paths = {}
    for rate in (SAMPLE_RATE, 44_100):
        audio = synthetic.synth_performance(events, 2.0, sample_rate=rate)
        paths[rate] = d / f"s{rate}.wav"
        audio_io.write_wav(paths[rate], audio, rate)
    return paths


def _same(a: np.ndarray, b: np.ndarray) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_builds_into_the_ports_own_directory():
    assert native.lib_path() == ROOT / "build" / "native" / "liba2m_native.so"
    assert native.lib_path().exists()


@pytest.mark.parametrize("rate", [SAMPLE_RATE, 44_100])
def test_decode_audio(wavs, rate):
    _same(native.decode_audio(wavs[rate], SAMPLE_RATE),
          jax_native.decode_audio(wavs[rate], SAMPLE_RATE))


@pytest.mark.parametrize("rate", [SAMPLE_RATE, 44_100])
def test_load_audio_sample_and_f16(wavs, rate):
    _same(native.load_audio_sample(wavs[rate], SAMPLE_RATE, 3),
          jax_native.load_audio_sample(wavs[rate], SAMPLE_RATE, 3))
    _same(native.load_audio_sample_f16(wavs[rate], SAMPLE_RATE, 3),
          jax_native.load_audio_sample_f16(wavs[rate], SAMPLE_RATE, 3))


def test_load_audio_sample_through_the_cache(wavs, tmp_path, monkeypatch):
    monkeypatch.setenv("SAMPLE_CACHE_DIR", str(tmp_path / "cache"))
    first = native.load_audio_sample(wavs[SAMPLE_RATE], SAMPLE_RATE)  # writes the cache
    assert any((tmp_path / "cache").rglob("*"))
    _same(native.load_audio_sample(wavs[SAMPLE_RATE], SAMPLE_RATE), first)  # reads it
    _same(jax_native.load_audio_sample(wavs[SAMPLE_RATE], SAMPLE_RATE), first)


def test_f16_converters():
    every_half = np.arange(2 ** 16, dtype=np.uint16).view(np.float16)
    _same(native.f16_to_f32_buf(every_half), jax_native.f16_to_f32_buf(every_half))
    f = np.random.default_rng(0).standard_normal(100_003).astype(np.float32) * 1e3
    f[:4] = [np.inf, -np.inf, np.nan, 65520.0]
    _same(native.f32_to_f16_buf(f), jax_native.f32_to_f16_buf(f))


def test_normalize_loudness():
    x = (np.random.default_rng(1).standard_normal((2, 30_000)) * 0.3).astype(np.float32)
    _same(native.normalize_loudness(x), jax_native.normalize_loudness(x))


def test_parse_events_csv(tmp_path):
    p = tmp_path / "l.csv"
    p.write_text("% header\n0.0,0.0,21,0.0\n1.0, 0.5, 60, 0.73\n2.005, 0.001, 21, 1.0\n"
                 "bad,row\n3.0,1e40,64,0.5\n0.5,0.25,-3,0.5\n0.25,0.25,70,nan\n")
    ours = native.parse_events_csv(p, 0.02)
    assert ours == jax_native.parse_events_csv(p, 0.02) and len(ours) == 4


def test_rasterize_events():
    events = [(5, 2, 10, 7), (20, 2, 4, 7), (3, 0, 50, 7), (1, 95, 3, 7)]
    for start, backing in ((0, 35), (4, 40), (0, None)):
        _same(native.rasterize_events(events, 40, start, backing, num_keys=4),
              jax_native.rasterize_events(events, 40, start, backing, num_keys=4))


@pytest.mark.parametrize("parity_pan", [False, True])
def test_transform_for_training(parity_pan):
    rng = np.random.default_rng(3)
    audio = np.ascontiguousarray(rng.standard_normal((8, 2, 500)), np.float32)
    labels = np.ascontiguousarray(rng.random((8, 20, 90)), np.float32)
    a1, l1, a2, l2 = audio.copy(), labels.copy(), audio.copy(), labels.copy()
    native.transform_for_training(
        a1, l1, TransformSettings(parity_pan_uses_channel_switch_probability=parity_pan), seed=42)
    jax_native.transform_for_training(
        a2, l2, JaxTransformSettings(parity_pan_uses_channel_switch_probability=parity_pan),
        seed=42)
    assert not np.array_equal(a1, audio)
    _same(a1, a2)
    _same(l1, l2)


def test_stitch_probs():
    probs = np.random.default_rng(1).random((4, 250, 8)).astype(np.float32)
    _same(native.stitch_probs(probs, 0.5, 0.02), jax_native.stitch_probs(probs, 0.5, 0.02))


def test_extract_events():
    probs = np.random.default_rng(2).random((300, 90)).astype(np.float32) ** 4
    ours = native.extract_events(probs)
    assert ours and ours == jax_native.extract_events(probs)


def test_disable_native_is_honoured():
    code = ("from audio_to_midi_tpu_torch import native; "
            "from audio_to_midi_tpu_torch.data import audio_io; "
            "print(native.available(), audio_io.use_native('a.wav'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          env={**os.environ, "A2M_DISABLE_NATIVE": "1"}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "False"]


def test_two_processes_that_build_at_once_both_load_a_working_library(tmp_path):
    code = textwrap.dedent(f"""
        import numpy as np
        from pathlib import Path
        from audio_to_midi_tpu_torch import native
        native._BUILD_DIR = Path({str(tmp_path)!r})
        assert native.available()
        h = native.f32_to_f16_buf(np.array([1.0, 2.5, -3.0], np.float32))
        print(h.tolist())
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "[1.0, 2.5, -3.0]"
    assert sorted(p.name for p in tmp_path.iterdir()) == [".lock", "liba2m_native.so"]


def test_a_failed_build_warns_and_leaves_the_numpy_path(tmp_path):
    (tmp_path / "cpp").mkdir()
    (tmp_path / "cpp" / "a2m_native.cpp").write_text("this is not C++\n")
    for name in ("a2m_native.h", "CMakeLists.txt"):
        (tmp_path / "cpp" / name).write_text((ROOT / "cpp" / name).read_text())
    code = textwrap.dedent(f"""
        import logging
        from pathlib import Path
        logging.basicConfig(level=logging.WARNING)
        from audio_to_midi_tpu_torch import native
        from audio_to_midi_tpu_torch.data import audio_io
        native._CPP_DIR = Path({str(tmp_path / "cpp")!r})
        native._BUILD_DIR = Path({str(tmp_path / "build")!r})
        print(native.available(), audio_io.use_native("a.wav"))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "False"]
    assert "WARNING:audio_to_midi_tpu_torch.native:native data plane unavailable" in proc.stderr
