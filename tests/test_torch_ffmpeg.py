"""The ffmpeg path of ``data/audio_io.py`` against the JAX package's: the
same command argument for argument (the temp files' names aside), and, with
fake ``ffmpeg`` / ``ffprobe`` scripts first on ``PATH`` (this machine has no
ffmpeg), the same arrays from ``decode_audio`` and ``load_full_audio_f16``
for an ``.aac`` (source rate probed, the encoder-delay trim) and an ``.mp3``
file, the temp files removed, and the same error where no decoder applies."""

import json
import os
import re
import stat
import sys
import textwrap

import numpy as np
import pytest

from audio_to_midi_tpu.data import audio_io as jax_audio_io
from audio_to_midi_tpu.data import loader as jax_loader
from audio_to_midi_tpu_torch.data import audio_io

UUID = re.compile(r"audio-to-midi-[0-9a-f-]+_")


def _normalised(cmd):
    return [UUID.sub("audio-to-midi-X_", str(a)) for a in cmd]


@pytest.mark.parametrize("src_rate", [None, 44100.0, 22050.0])
def test_ffmpeg_command_is_jax_s(src_rate):
    ours, left, right = audio_io._ffmpeg_command("in.aac", 16000, src_rate)
    ref, ref_left, ref_right = jax_audio_io._ffmpeg_command("in.aac", 16000, src_rate)
    assert _normalised(ours) == _normalised(ref)
    assert _normalised([left, right]) == _normalised([ref_left, ref_right])
    assert left.parent == ref_left.parent and left != ref_left  # a fresh name per call
    assert ("-c:a" in ours) == (src_rate is not None)


FAKE_FFMPEG = """
import json, os, sys
import numpy as np
args = sys.argv[1:]
with open(os.environ["FAKE_FFMPEG_LOG"], "a") as log:
    log.write(json.dumps(args) + "\\n")
src = args[args.index("-i") + 1]
seed = len(open(src, "rb").read()) + (7 if "-c:a" in args else 0)
rng = np.random.default_rng(seed)
outs = [args[i + 1] for i, a in enumerate(args) if a == "f32le"]
rate = int(args[args.index("-ar") + 1])
for n, path in zip((rate + 3, rate), outs):  # the channels' lengths differ
    rng.standard_normal(n).astype(np.float32).tofile(path)
"""
FAKE_FFPROBE = """
import sys
assert sys.argv[1].endswith(".aac") and "stream=sample_rate" in sys.argv
print("44100")
"""


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name, body in (("ffmpeg", FAKE_FFMPEG), ("ffprobe", FAKE_FFPROBE)):
        script = bin_dir / name
        script.write_text(f"#!{sys.executable}\n" + textwrap.dedent(body))
        script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_FFMPEG_LOG", str(tmp_path / "calls.jsonl"))
    monkeypatch.setattr(audio_io.tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    return tmp_path


@pytest.mark.parametrize("suffix", [".aac", ".mp3"])
def test_decode_audio_through_ffmpeg_matches_jax(fake_ffmpeg, suffix):
    path = fake_ffmpeg / f"x{suffix}"
    path.write_bytes(b"\0" * 1234)
    assert not audio_io.use_native(path)
    ours = audio_io.decode_audio(path, 16000)
    ref = jax_audio_io.decode_audio(path, 16000)
    assert ours.shape == (2, 16000) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(audio_io.load_full_audio_f16(path, 16000),
                                  jax_loader.load_full_audio_f16(path, 16000))
    calls = [json.loads(line) for line in (fake_ffmpeg / "calls.jsonl").read_text().splitlines()]
    assert len(calls) == 4 and _normalised(calls[0]) == _normalised(calls[1])
    trim = f"atrim=start={2 * 1024 / 44100.0}"
    assert any(trim in a for a in calls[0]) == (suffix == ".aac")
    assert list((fake_ffmpeg / "tmp").iterdir()) == []  # the raw outputs removed


def test_no_decoder_is_the_same_error(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # no ffmpeg on it
    path = tmp_path / "x.ogg"
    path.write_bytes(b"\0")
    with pytest.raises(audio_io.AudioDecodeError) as ours:
        audio_io.decode_audio(path, 16000)
    with pytest.raises(jax_audio_io.AudioDecodeError) as ref:
        jax_audio_io.decode_audio(path, 16000)
    assert str(ours.value) == str(ref.value)
