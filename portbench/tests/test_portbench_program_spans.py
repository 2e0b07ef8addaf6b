"""The readers of the program's spans: a traced serving run on the CPU at a
tiny size gives each of them, ``cast_ms.serve`` in bf16 only, and each
gives None where the recorder is empty or the run was not traced."""

import time

import pytest
import torch

from portbench import manifest
from portbench.drivers import serve

READERS = ("h2d_ms.serve", "resample_ms.serve", "cast_ms.serve", "forward_host_ms.serve")


@pytest.fixture
def recorder():
    from audio_to_midi_tpu_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.reset()


@pytest.mark.parametrize("name,read", [("config_f32", READERS[:2] + READERS[3:]),
                                       ("config_bf16", READERS)])
def test_a_traced_run_gives_the_program_span_metrics(name, read, mix, recorder, request):
    config = request.getfixturevalue(name)
    out = serve.run(config, mix, 2 ** 33 + 5, 1.0, True, torch.device("cpu"),
                    time.perf_counter())
    assert out["correct"], out["checks"]
    spans = recorder.summary()
    # The traced cycle alone: one root span per recording of the ladder.
    assert spans["serve.transcribe"]["calls"] == mix["trace_cycles"] * len(mix["ladder_s"])
    ctx = dict(out, config=config)
    values = {m: manifest.reader(m).read(ctx) for m in READERS}
    assert {m for m, v in values.items() if v is not None} == set(read)
    assert all(values[m] > 0 for m in read)
    calls = spans["serve.transcribe"]["calls"]
    assert values["forward_host_ms.serve"] == spans["model.forward"]["total_ns"] / calls / 1e6


@pytest.mark.parametrize("metric", READERS)
def test_each_reader_gives_none_on_an_empty_recorder(metric, recorder):
    reader = manifest.reader(metric)
    assert reader.read({"trace": {"window_s": 1.0, "busy_s": 0.5}}) is None
    with recorder.recording():
        with recorder.span("serve.transcribe"):
            pass
    assert reader.read({"trace": {"window_s": 1.0, "busy_s": 0.5}}) is None
    assert reader.read({"trace": None}) is None
