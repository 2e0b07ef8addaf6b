"""A whole serving run on the CPU at a tiny size, with the look for a card
skipped: the metrics' arithmetic, and the output check against the
reference, the control and the program broken underneath."""

import time

import pytest
import torch

from portbench import calibrate, check
from portbench.drivers import serve

CPU = torch.device("cpu")


def _run(config, mix, seconds=2.0, seed=2 ** 33 + 1, **kw):
    return serve.run(config, mix, seed, seconds, False, CPU, time.perf_counter(), **kw)


def test_p95_over_all_recordings_moves_with_one_stall():
    ms = [100.0] * 19
    stalled = sorted(ms[:-1] + [1100.0])
    assert serve._p95(ms) == 100.0
    assert serve._p95(stalled) > 100.0 + 40.0
    assert serve._p95(ms + [float("inf")]) == float("inf")


def test_rate_is_all_work_over_all_time(config_f32, mix, monkeypatch):
    base = _run(config_f32, mix, seconds=1.0)
    e2e, c = base["end_to_end"], base["counters"]
    assert e2e["audio_s_per_s"] == pytest.approx(c["audio_s"] / c["window_s"])
    assert c["recordings"] == base["attempted"] and base["failed"] == 0
    assert base["correct"]

    real = serve.Server.serve
    calls = []

    def stall(self, req):
        calls.append(req.index)
        if req.index == 1:   # one stall inside the window
            time.sleep(1.5)
        return real(self, req)

    monkeypatch.setattr(serve.Server, "serve", stall)
    slow = _run(config_f32, mix, seconds=1.0)
    assert slow["counters"]["window_s"] >= 1.5
    assert slow["end_to_end"]["audio_s_per_s"] == pytest.approx(
        slow["counters"]["audio_s"] / slow["counters"]["window_s"])
    assert slow["end_to_end"]["recording_p95_ms"] >= 1000.0


@pytest.mark.parametrize("name", ["config_f32", "config_bf16"])
def test_sound_run_is_correct_and_the_control_is_not(name, mix, request):
    """A whole run is correct; the calibration's readings, which take the
    run's own check path, judge the program correct and the control (the
    reference at the configuration's lower precision in the program's
    place) not."""
    config = request.getfixturevalue(name)
    sound = _run(config, mix)
    assert sound["correct"], sound["checks"]
    reading = calibrate._read(config, mix, 2 ** 33 + 1, CPU, control=True)
    assert reading["correct"] == {"program": True, "control": False}, reading
    correct, checks = check.judge(reading["control"], config["check"]["serve"], 0)
    assert not correct
    assert any(c["value"] > c["limit"] for c in checks.values())


def _halve(predict):
    """Half of each batch of windows left out: their probabilities are the
    mean over the rest."""
    def broken(model, cfg, windows, rope):
        probs = predict(model, cfg, windows, rope)
        keep = probs[: (probs.shape[0] + 1) // 2]
        return torch.cat([keep, keep.mean(0, keepdim=True).expand(probs.shape[0] - keep.shape[0],
                                                                  *probs.shape[1:])])
    return broken


def _alter_note(extract):
    def broken(probs, *a, **k):
        notes = extract(probs, *a, **k)
        if notes:
            attack, key, length, velocity = notes[0]
            notes[0] = (attack, key, length + 1, velocity)
        return notes
    return broken


def _alter_prob(stitch):
    def broken(*a, **k):
        out = stitch(*a, **k)
        out[out.shape[0] // 2, 3] += 0.01
        return out
    return broken


@pytest.mark.parametrize("fault", ["half_the_batch", "a_note_altered", "a_probability_altered"])
def test_faults_in_the_timed_path_are_not_correct(fault, config_f32, mix, monkeypatch):
    from audio_to_midi_tpu_torch import infer
    from audio_to_midi_tpu_torch.ops import eventize

    if fault == "half_the_batch":
        monkeypatch.setattr(infer, "_predict_windows", _halve(infer._predict_windows))
    elif fault == "a_note_altered":
        monkeypatch.setattr(eventize, "extract_events", _alter_note(eventize.extract_events))
    else:
        monkeypatch.setattr(infer, "stitch_probs_parallel", _alter_prob(infer.stitch_probs_parallel))
    out = _run(config_f32, mix)
    assert not out["correct"], out["checks"]


def test_a_failing_request_is_counted_and_not_correct(config_f32, mix, monkeypatch):
    from audio_to_midi_tpu_torch import infer

    real = infer.transcribe_samples_fused
    count = [0]

    def flaky(*a, **k):
        count[0] += 1
        if count[0] == 4:   # the first request of the window (three warm it up)
            raise RuntimeError("injected")
        return real(*a, **k)

    monkeypatch.setattr(infer, "transcribe_samples_fused", flaky)
    out = _run(config_f32, mix)
    assert out["failed"] == 1 and not out["correct"]
    assert out["attempted"] == out["counters"]["recordings"] + 1
