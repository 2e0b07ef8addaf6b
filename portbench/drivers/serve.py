"""Serving driver: one client transcribes recordings it holds in memory, in
a closed loop.

Each request calls ``infer.transcribe_samples_fused`` on a (2, N) float32
numpy array at the mix's source rate, then ``ops/eventize.extract_events``
on the stitched probabilities it returns.  A request is timed from the call,
with the audio in pageable host memory, to the note list in host memory.
Between the two calls the host waits for the card, so that the
``extract_events`` span holds the eventizer alone; the wait is part of the
request either way.

Set-up: the kernels (built or loaded), the weights and the master audio
made on the card from the seed, the recordings cut into host memory, and one
request at every length of the ladder, so that every batch shape of the
window is warm.  Then requests run until ``seconds`` have passed, and the
last one finishes.  A ``--trace 1`` run then traces ``trace_cycles`` more
cycles, and the output check runs after all of that.
"""

from __future__ import annotations

import gc
import logging
import time
import traceback

import torch

from .. import check, generate, trace, weights
from ..reference import frontend as ref_frontend
from ..spans import GcPauses, Spans

log = logging.getLogger("portbench")

OPS = ("a2m::global_attention_fwd", "a2m::local_two_phase_fwd")
SPANS = ("transcribe", "extract_events")


def port_config(config: dict):
    """The port's ``Config`` of a configuration file: model, data, precision."""
    from audio_to_midi_tpu_torch.config import Config, DataConfig, ModelConfig, PrecisionConfig

    model = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in config["model"].items()})
    data = DataConfig(frequency_cutoff=config["data"]["sample_rate"] // 2,
                      model_audio_length=config["data"]["window_s"])
    return Config(model=model, data=data, precision=PrecisionConfig(**config["precision"]))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Server:
    """The program under test as the client sees it, with the recordings."""

    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        from audio_to_midi_tpu_torch import infer
        from audio_to_midi_tpu_torch.config import DTYPES
        from audio_to_midi_tpu_torch.models import model as model_lib
        from audio_to_midi_tpu_torch.ops import cuda_build, eventize

        t0 = time.perf_counter()
        if device.type == "cuda":
            cuda_build.library()
        t1 = time.perf_counter()
        self.infer, self.eventize = infer, eventize
        self.device, self.mix = device, mix
        self.cfg = port_config(config)
        with torch.device("meta"):
            model = model_lib.Model(self.cfg.model)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        self.params = weights.make(shapes, seed, device)
        t2 = time.perf_counter()

        self.ladder = generate.Ladder(mix, seed)
        master = generate.master(mix, seed, device)
        rate = mix["src_rate"]
        data = config["data"]
        probe = ref_frontend.prepare(
            master[:, : round(mix["density_probe_s"] * rate)], rate, data["sample_rate"],
            round(data["window_s"] * data["sample_rate"]), round(mix["overlap_s"] * data["sample_rate"]))
        density = weights.set_note_density(self.params, config["model"], probe, mix["overlap_s"],
                                           data["window_s"], mix["notes_per_s"],
                                           mix["density_probe_s"])
        del probe
        t3 = time.perf_counter()
        model = model.to_empty(device=device)
        model.load_state_dict(self.params)
        self.model = model.to(DTYPES[self.cfg.precision.param_dtype]).eval()
        self.rope = model_lib.make_rope(self.cfg.model, device)
        t4 = time.perf_counter()
        self.audio = {}
        for s in range(self.ladder.sets):
            for rung, seconds in enumerate(self.ladder.lengths):
                start = round(self.ladder.offset(s, rung, mix["master_s"]) * rate)
                self.audio[s, rung] = master[:, start: start + round(seconds * rate)].cpu().numpy()
        del master
        log.info("set-up: kernels %.2f s, weights %.2f s, note density %.2f s (%s), model %.2f s, "
                 "audio %.2f s", t1 - t0, t2 - t1, t3 - t2, density, t4 - t3,
                 time.perf_counter() - t4)
        self.spans = Spans()

    def serve(self, req: generate.Request):
        """One request: (stitched probabilities on the device, notes)."""
        samples = self.audio[req.set, req.rung]
        with self.spans.span("transcribe"):
            stitched = self.infer.transcribe_samples_fused(
                self.model, self.cfg, samples, self.rope, self.mix["src_rate"],
                self.cfg.data.model_audio_length, self.mix["overlap_s"])
            _sync(self.device)
        with self.spans.span("extract_events"):
            notes = self.eventize.extract_events(stitched)
        return stitched, notes

    def windows(self, req) -> int:
        return generate.windows_for(req.seconds, self.cfg.data.sample_rate,
                                    self.cfg.data.model_audio_length, self.mix["overlap_s"])


def run(config: dict, mix: dict, seed: int, seconds: float, traced: bool,
        device: torch.device, t_process: float) -> dict:
    """One run of a serving cell."""
    server = Server(config, mix, seed, device)
    per_cycle = len(server.ladder.lengths)
    t0 = time.perf_counter()
    for rung, length in enumerate(server.ladder.lengths):   # every batch shape, once
        server.serve(generate.Request(-1, rung, length, 0))
    _sync(device)
    log.info("set-up: warm-up %.2f s", time.perf_counter() - t0)
    server.spans = Spans()
    # What set-up left behind is no garbage of the window's.
    gc.collect()
    gc.freeze()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    keep = mix["check_cycles"] * per_cycle
    outputs, times = {}, []
    attempted = failed = windows_done = notes_done = 0
    audio_s = 0.0
    stitched = notes = None
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    index = 0
    gc_pauses = GcPauses()
    gc.callbacks.append(gc_pauses)
    while time.perf_counter() - t_start < seconds:
        t0 = time.perf_counter()
        attempted += 1
        req = server.ladder.request(index)
        try:
            stitched, notes = server.serve(req)
        except Exception:  # a failed request is counted, and the run is not correct
            failed += 1
            log.error("request %d failed:\n%s", index, traceback.format_exc())
            index += 1
            continue
        times.append(time.perf_counter() - t0)
        audio_s += req.seconds
        windows_done += server.windows(req)
        notes_done += len(notes)
        if index < keep:
            outputs[index] = (req, stitched, notes)
        index += 1
    t_end = time.perf_counter()
    gc.callbacks.remove(gc_pauses)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    spans = server.spans

    summary = None
    if traced:
        summary = _trace(server, index, mix["trace_cycles"] * per_cycle)

    requests, program = check.sample(outputs, seed, mix["check_sample"])
    params, audio = server.params, server.audio
    del outputs, server, stitched, notes
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    values = check.readings(program, requests, params, config, mix, audio, device)["program"]
    correct, checks = check.judge(values, config["check"]["serve"], failed)
    correct = correct and bool(requests)

    window_s = t_end - t_start
    ms = sorted(1000.0 * t for t in times) + [float("inf")] * failed
    return {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "end_to_end": {
            "audio_s_per_s": audio_s / window_s,
            "recording_p95_ms": _p95(ms),
            "setup_s": setup_s,
        },
        "counters": {"windows": windows_done, "recordings": len(times), "audio_s": audio_s,
                     "notes": notes_done, "window_s": window_s, "gc_s": gc_pauses.total,
                     "gc_pauses": gc_pauses.count},
        "spans": spans,
        "trace": summary,
        "memory_peak_bytes": peak,
        "checks": checks,
        "sample": [r.seconds for r in requests],
    }


def _trace(server: Server, first: int, count: int) -> dict:
    """Trace ``count`` requests from index ``first`` on; their summary."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if server.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    server.spans.tracing = True
    with profile(activities=activities, record_shapes=True) as prof:
        with record_function(trace.WINDOW):
            for index in range(first, first + count):
                server.serve(server.ladder.request(index))
            _sync(server.device)
    server.spans.tracing = False
    return trace.summarize(prof, SPANS, OPS)


def _p95(ms: list) -> float:
    """The 95th percentile by linear interpolation between closest ranks."""
    if not ms:
        return float("inf")
    pos = 0.95 * (len(ms) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(ms) - 1)
    return ms[lo] + (ms[hi] - ms[lo]) * (pos - lo)
