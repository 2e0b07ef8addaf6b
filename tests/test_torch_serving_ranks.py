"""The serving CLI on two ranks: ``torchrun --nproc-per-node 2`` over gloo
on the CPU (the port's counterpart of the JAX CLI on several devices,
``cli/audio_to_midi.py:139-147``) writes the MIDI of one rank byte for
byte, and only rank 0 reports."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from audio_to_midi_tpu_torch import config as pt_config
from audio_to_midi_tpu_torch import convert
from audio_to_midi_tpu_torch.cli import audio_to_midi as pt_cli
from audio_to_midi_tpu_torch.data.audio_io import write_wav
from audio_to_midi_tpu_torch.models import model as pt_model
from tests.test_torch_primitives import SMALL_CFG

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def test_two_rank_cli_writes_the_one_rank_midi(tmp_path, capsys):
    model = pt_model.Model(SMALL_CFG.model, torch.Generator().manual_seed(21))
    convert.save_npz(tmp_path / "params.npz", convert.state_dict_to_jax(model.state_dict()))
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(pt_config.config_to_json(SMALL_CFG))
    # 12 s at 16 kHz: 5 windows of 5 s at the 0.5 s overlap, an odd count
    # that leaves the last data shard padded.
    t = np.arange(12 * 16000) / 16000
    rng = np.random.default_rng(22)
    audio = np.stack([np.sin(2 * np.pi * 440 * t), np.sin(2 * np.pi * 660 * t)]) * 0.3
    write_wav(tmp_path / "in.wav", (audio + 0.05 * rng.standard_normal(audio.shape)).astype(
        np.float32), 16000)
    common = ["--checkpoint", str(tmp_path / "params.npz"), "--config", str(cfg_path),
              "--device", "cpu"]
    assert pt_cli.main([str(tmp_path / "in.wav"), str(tmp_path / "one.mid")] + common) == 0
    one = capsys.readouterr().out
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    env.update(OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "audio_to_midi_tpu_torch.cli.audio_to_midi", str(tmp_path / "in.wav"),
         str(tmp_path / "two.mid")] + common,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert (tmp_path / "two.mid").read_bytes() == (tmp_path / "one.mid").read_bytes()
    # Rank 0 alone prints: the one-rank report once, the file name its own.
    assert proc.stdout.count("Extracted ") == 1
    assert proc.stdout.replace("two.mid", "one.mid").strip() == one.strip()
