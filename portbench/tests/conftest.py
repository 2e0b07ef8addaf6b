"""Small shapes for the CPU: the default model's geometry cut to a few
channels and layers (5 s windows of 250 frames, as at full size), and the
pieces mix cut to three short rungs."""

import json

import pytest
import torch

from portbench import manifest

torch.set_num_threads(2)   # a shared CPU: more threads contend and run slower

TINY_MODEL = dict(dims=[4, 4, 4, 4, 4, 8, 16], depths=[1, 1, 1, 1, 1, 2, 1],
                  num_transformer_layers=2, num_transformer_heads=2, attention_size=8,
                  compressed_attention_q_size=8, compressed_attention_kv_size=8)


def tiny_config(name: str) -> dict:
    config = json.loads((manifest.BENCH / "configs" / f"{name}.json").read_text())
    config["model"].update(TINY_MODEL)
    return config


def tiny_mix() -> dict:
    mix = json.loads((manifest.BENCH / "traffic" / "pieces.json").read_text())
    mix.update(ladder_s=[6, 11, 16], master_s=20, density_probe_s=10)
    return mix


def tiny_train_mix() -> dict:
    mix = json.loads((manifest.BENCH / "traffic" / "b512-ring.json").read_text())
    mix.update(batch=8, minibatch=4, ring_capacity=16, loader_workers=1, warm_steps=4,
               trace_steps=2, reference_block=4,
               dataset={"files": 2, "file_s": 22, "notes_per_file": 40, "seed": 7})
    return mix


@pytest.fixture
def config_f32():
    return tiny_config("a2m-f32")


@pytest.fixture
def config_bf16():
    return tiny_config("a2m-bf16")


@pytest.fixture
def mix():
    return tiny_mix()


@pytest.fixture
def train_mix():
    return tiny_train_mix()


@pytest.fixture
def config_train_f32():
    """The training configuration at the tiny size with f32 compute, where
    the program and the reference agree to round-off and a fault stands out
    against its limits."""
    config = tiny_config("a2m-bf16")
    config["precision"]["compute_dtype"] = "f32"
    return config
