"""The span recorder of ``utils/profiling.py`` on the port's serving path, on
the CPU at a tiny size: off by default, on under a ``torch.profiler``
profile (each span a range of the trace, inside its parent's, with its
request id) and inside ``recording()``; one of each span per call, exact
counters, self time as total less children, and outputs bit for bit the
same with spans on and off."""

import json
import math
import threading

import numpy as np
import pytest
import torch

from audio_to_midi_tpu_torch import infer
from audio_to_midi_tpu_torch.config import Config, ModelConfig, PrecisionConfig
from audio_to_midi_tpu_torch.models import model as model_lib
from audio_to_midi_tpu_torch.ops.eventize import extract_events
from audio_to_midi_tpu_torch.utils import profiling

torch.set_num_threads(2)

TINY = ModelConfig(dims=(4, 4, 4, 4, 4, 8, 16), depths=(1, 1, 1, 1, 1, 2, 1),
                   num_transformer_layers=2, num_transformer_heads=2, attention_size=8,
                   compressed_attention_q_size=8, compressed_attention_kv_size=8)
SRC_RATE, SECONDS, WINDOW_S, OVERLAP_S = 44_100, 6.0, 5.0, 0.5

# Each span and its parent ("" for a root).
PARENT = {
    "serve.transcribe": "",
    "frontend.h2d": "serve.transcribe",
    "frontend.resample": "serve.transcribe",
    "frontend.resample_table": "frontend.resample",
    "frontend.windows": "serve.transcribe",
    "serve.cast_model": "serve.transcribe",
    "model.forward": "serve.transcribe",
    "ops.stitch": "serve.transcribe",
    "eventize": "",
    "eventize.kernel": "eventize",
    "eventize.fetch": "eventize",
    "eventize.host": "eventize",
}


def _spans(dtype: str) -> set[str]:
    return set(PARENT) - ({"serve.cast_model"} if dtype == "f32" else set())


@pytest.fixture(scope="module")
def serving():
    torch.manual_seed(3)
    model = model_lib.Model(TINY).eval()
    t = np.arange(int(SECONDS * SRC_RATE)) / SRC_RATE
    tone = np.sin(2 * np.pi * 440.0 * t) * np.exp(-np.mod(t, 0.5) * 4)
    audio = (0.5 * np.stack([tone, 0.7 * tone])).astype(np.float32)
    return model, model_lib.make_rope(TINY), audio


def _serve(serving, dtype: str):
    model, rope, audio = serving
    cfg = Config(model=TINY, precision=PrecisionConfig("f32", dtype))
    stitched = infer.transcribe_samples_fused(model, cfg, audio, rope, SRC_RATE, WINDOW_S,
                                              OVERLAP_S)
    return stitched, extract_events(stitched)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_spans_are_off_by_default_and_outputs_are_the_same_on_and_off(serving, dtype):
    profiling.reset()
    assert profiling.span("serve.transcribe") is profiling.span("eventize")  # the shared no-op
    stitched, notes = _serve(serving, dtype)
    assert profiling.summary() == {}
    with profiling.recording():
        recorded = _serve(serving, dtype)
    with torch.profiler.profile(record_shapes=True):
        traced = _serve(serving, dtype)
    assert set(profiling.summary()) == _spans(dtype)
    for on_stitched, on_notes in (recorded, traced):
        assert torch.equal(on_stitched, stitched) and on_notes == notes
    assert len(notes) > 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_trace_holds_every_span_inside_its_parent_with_the_request_id(serving, dtype, tmp_path):
    profiling.reset()
    with torch.profiler.profile(record_shapes=True) as prof:
        _serve(serving, dtype)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name") in PARENT}
    assert set(events) == _spans(dtype)
    for name, parent in PARENT.items():
        if name not in events:
            continue
        e = events[name]
        root = events["eventize" if name.startswith("eventize") else "serve.transcribe"]
        assert e["args"]["request"] == root["args"]["request"], name
        if parent:
            p = events[parent]
            assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"], name
    assert events["serve.transcribe"]["args"]["request"] != events["eventize"]["args"]["request"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_summary_counts_one_of_each_span_per_call_and_exact_counters(serving, dtype):
    model, _rope, audio = serving
    profiling.reset()
    with profiling.recording():
        stitched, notes = _serve(serving, dtype)
    spans = profiling.summary()
    assert set(spans) == _spans(dtype)
    assert all(s["calls"] == 1 for s in spans.values())
    for s in spans.values():
        assert 0 <= s["self_ns"] <= s["total_ns"]
    counts = {name: s["counts"] for name, s in spans.items()}
    # The resampler 44.1 -> 16 kHz: up 160, down 441 after their gcd; its
    # index table is (ceil(out / up), up) int64.
    up, down = 160, 441
    out = math.ceil(audio.shape[1] * up / down)
    step = round((WINDOW_S - OVERLAP_S) * 16_000)
    windows = max(1, math.ceil((out - round(OVERLAP_S * 16_000)) / step))
    assert counts["serve.transcribe"] == {"samples": audio.shape[1]}
    assert counts["frontend.h2d"] == {"bytes": audio.nbytes}
    assert counts["frontend.resample"] == {"samples": out}
    assert counts["frontend.resample_table"] == {"bytes": -(-out // up) * up * 8}
    assert counts["frontend.windows"] == {"windows": windows}
    assert counts["model.forward"] == {"windows": windows}
    assert counts["ops.stitch"] == {"frames": stitched.shape[0]}
    assert counts["eventize"] == {"frames": stitched.shape[0], "notes": len(notes)}
    if dtype == "bf16":
        tensors = [*model.parameters(), *model.buffers()]
        assert counts["serve.cast_model"] == {
            "leaves": len(tensors), "bytes": sum(t.numel() for t in tensors) * 2}
    # Calls and counts add up over calls; reset forgets them.
    with profiling.recording():
        _serve(serving, dtype)
    again = profiling.summary()["model.forward"]
    assert again["calls"] == 2 and again["counts"] == {"windows": 2 * windows}
    assert again["total_ns"] > spans["model.forward"]["total_ns"]
    profiling.reset()
    assert profiling.summary() == {}


def test_self_time_is_total_less_children_under_an_injected_clock(monkeypatch):
    ticks = iter([0, 10, 15, 40, 100, 130, 160, 200])
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    profiling.reset()
    with profiling.recording():
        with profiling.span("a"):              # 0 .. 200
            with profiling.span("b"):          # 10 .. 100
                with profiling.span("c"):      # 15 .. 40
                    pass
            with profiling.span("b") as b:     # 130 .. 160
                b.add("n", 2)
    spans = profiling.summary()
    assert spans["c"] == {"calls": 1, "total_ns": 25, "self_ns": 25, "counts": {}}
    assert spans["b"] == {"calls": 2, "total_ns": 90 + 30, "self_ns": 90 - 25 + 30,
                          "counts": {"n": 2}}
    assert spans["a"] == {"calls": 1, "total_ns": 200, "self_ns": 200 - 120, "counts": {}}


def test_recording_turns_spans_on_in_every_thread_without_a_profiler():
    profiling.reset()
    assert not profiling.span("x").on

    @profiling.annotate("annotated")
    def work():
        with profiling.span("inner") as s:
            return getattr(s, "request", None)

    assert work() is None
    with profiling.recording():
        with profiling.recording():
            assert profiling.span("x").on
        assert profiling.span("x").on
        requests = [work(), work()]
        seen = []
        thread = threading.Thread(target=lambda: seen.append(work()))
        thread.start()
        thread.join(timeout=30)
        assert not thread.is_alive()
    assert not profiling.span("x").on
    spans = profiling.summary()
    assert spans["annotated"]["calls"] == spans["inner"]["calls"] == 3
    assert len(set(requests + seen)) == 3   # each root its own request


def test_stage_times_are_the_file_spans(serving, tmp_path):
    from audio_to_midi_tpu_torch.data.audio_io import write_wav

    model, rope, audio = serving
    path = tmp_path / "song.wav"
    write_wav(path, audio[:, ::3], 16_000)   # 5.5 s at 16 kHz: 2 windows
    cfg = Config(model=TINY, precision=PrecisionConfig("f32", "f32"))
    profiling.reset()
    off = infer.transcribe_file(model, cfg, path, rope=rope)
    assert profiling.summary() == {}
    stages = {}
    on = infer.transcribe_file(model, cfg, path, rope=rope, stage_times=stages)
    spans = profiling.summary()
    assert list(stages) == ["decode", "transfer", "window", "model_stitch", "eventize", "fetch"]
    assert {f"file.{k}" for k in stages} | {"file.transcribe"} <= set(spans)
    for key, seconds in stages.items():
        assert seconds == spans[f"file.{key}"]["total_ns"] / 1e9
    assert spans["model.forward"]["counts"] == {"windows": 2}
    np.testing.assert_array_equal(on[0], off[0])
    assert on[2] == off[2]
