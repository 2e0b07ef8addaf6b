"""A whole training run on the CPU at a tiny size, with the look for a card
skipped: the rate's arithmetic, the reference against the program, and the
output check with the step broken underneath."""

import time

import pytest
import torch

from portbench import calibrate, counters
from portbench.drivers import train

CPU = torch.device("cpu")
SEED = 2 ** 33 + 7


def _run(config, mix, seconds=2.0, seed=SEED):
    return train.run(config, mix, seed, seconds, False, CPU, time.perf_counter())


def test_rate_is_whole_steps_over_the_window(config_train_f32, train_mix):
    out = _run(config_train_f32, train_mix)
    c = out["counters"]
    assert c["steps"] == out["attempted"] >= 1 and out["failed"] == 0
    assert c["windows"] == c["steps"] * train_mix["batch"]
    assert out["end_to_end"]["train_windows_per_s"] == pytest.approx(c["windows"] / c["window_s"])
    assert c["window_s"] >= 2.0
    assert out["correct"], out["checks"]


def test_the_reference_follows_the_program_in_f32(config_train_f32, train_mix):
    """Same rows, dropout draws and weights: the plain steps agree with the
    program's to f32 round-off, so the reference's dropout, loss and
    optimizer are the program's."""
    reading = calibrate._read(config_train_f32, train_mix, SEED, CPU, control=False)
    assert reading["program"]["loss_gap"] < 1e-6
    assert reading["program"]["grad_norm_gap"] < 1e-4
    assert reading["program"]["change_norm_gap"] < 1e-3


def test_train_flops_count_forward_and_backward():
    """The counter against PyTorch's count of a tiny plain forward and
    backward: the backward's matrix products are twice the forward's.  Its
    convolution backward is taken as twice the forward (less the stem's
    input gradient), since PyTorch counts a strided convolution's input
    gradient densely, as if every zero of the stride were multiplied."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.model import Reference
    from portbench.weights import make

    from .conftest import tiny_config

    model = tiny_config("a2m-bf16")["model"]
    params = {k: v.requires_grad_() for k, v in make(_shapes(model), 1, CPU).items()}
    x = torch.randn(1, 2, 80000)
    with FlopCounterMode(display=False) as forward:
        logits, _ = Reference(params, model).forward(x)
    with FlopCounterMode(display=False) as backward:
        logits.sum().backward()
    fwd = {str(k): v for k, v in forward.get_flop_counts()["Global"].items()}
    bwd = {str(k): v for k, v in backward.get_flop_counts()["Global"].items()}
    assert bwd["aten.mm"] == 2 * fwd["aten.mm"] and bwd["aten.bmm"] == 2 * fwd["aten.bmm"]
    stem = 2 * 16000 * 5 * 2 * model["dims"][0]
    expected = forward.get_total_flops() + 2 * sum(fwd.values()) - stem
    assert counters.train_flops(model, 80000) == expected


def _shapes(model_cfg: dict) -> dict:
    from audio_to_midi_tpu_torch.config import ModelConfig
    from audio_to_midi_tpu_torch.models import model as model_lib

    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in model_cfg.items()})
    with torch.device("meta"):
        m = model_lib.Model(cfg)
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def _unchanged(monkeypatch):
    """A step that returns its state unchanged: the optimizer applies nothing."""
    from audio_to_midi_tpu_torch.train import optim

    monkeypatch.setattr(optim.LayerwiseAdamW, "apply", lambda self, updates: None)


def _half_the_batch(monkeypatch):
    """Half of each minibatch left out, the mean taken over the rest."""
    from audio_to_midi_tpu_torch.train import step

    real = step.batch_loss

    def broken(model, cfg, audio, labels, *a, **k):
        half = audio.shape[0] // 2
        return real(model, cfg, audio[:half], labels[:half], *a, **k)

    monkeypatch.setattr(step, "batch_loss", broken)


@pytest.mark.parametrize("fault", [_unchanged, _half_the_batch], ids=lambda f: f.__name__)
def test_faults_in_the_timed_step_are_not_correct(fault, config_train_f32, train_mix,
                                                  monkeypatch):
    fault(monkeypatch)
    out = _run(config_train_f32, train_mix, seconds=0.5)
    assert not out["correct"], out["checks"]


def test_the_control_and_the_half_batch_are_not_correct(config_train_f32, train_mix):
    """The calibration's readings, which take a run's own check path: the
    program is correct, and the control (the reference with fp8 operands in
    the program's place) and the half-batch fault (the reference with each
    minibatch's second half left out) are not."""
    reading = calibrate._read(config_train_f32, train_mix, SEED + 2, CPU, control=True)
    assert reading["correct"] == {"program": True, "control": False, "half_batch": False}, reading
