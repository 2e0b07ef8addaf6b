"""The import guard: JAX and the JAX package by whole top-level name."""

import subprocess
import sys

import pytest

from portbench.run import forbidden_modules


@pytest.mark.parametrize("modules,found", [
    (["audio_to_midi_tpu_torch", "audio_to_midi_tpu_torch.infer", "torch"], []),
    (["audio_to_midi_tpu.config"], ["audio_to_midi_tpu"]),
    (["jax.numpy", "jaxlib"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "flaxen", "audio_to_midi_tpu_tools"], []),
])
def test_top_level_names_compared_whole(modules, found):
    assert forbidden_modules(dict.fromkeys(modules)) == found


def test_what_a_run_imports_loads_no_jax():
    code = ("import portbench.run, portbench.calibrate, portbench.drivers.serve, "
            "audio_to_midi_tpu_torch.infer, audio_to_midi_tpu_torch.ops.eventize; "
            "from portbench.run import forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "serve-f32",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
