"""The program's spans on one served recording, and what they cost.

    python3 tools/torch_serve_spans.py --out DIR [--cells serve-f32 serve-bf16] [--seed 7]

For each serving cell of ``BENCHMARK.json`` (its configuration, weights and
audio made from the seed as the benchmark makes them), the longest recording
of the ladder is transcribed (``infer.transcribe_samples_fused``) and
eventized (``ops/eventize.extract_events``) after a warm call, three times:
with spans off, inside ``utils/profiling.recording()`` (whose summary gives
each span's host time, unstretched by a profiler) and inside
``utils/profiling.trace``.  The stitched probabilities and the notes of the
three must be equal bit for bit.  From the Chrome trace: every program span,
whether it lies inside its parent with its root's request id,
``serve.transcribe``'s self time as a share of its duration, and the
device's idle gaps inside the two roots, each named by the innermost program
span around its midpoint.  Last, the host's ns per span: off, inside
``recording()`` and under a profiler.  Writes ``<out>/serve_spans.json``;
exits 1 where the outputs differ or a span is missing or out of place.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from audio_to_midi_tpu_torch.ops.eventize import extract_events  # noqa: E402
from audio_to_midi_tpu_torch.utils import profiling  # noqa: E402
from portbench import manifest  # noqa: E402
from portbench.drivers import serve  # noqa: E402

# Each program span on the serving path and its parent ("" for a root).
PARENT = {
    "serve.transcribe": "", "frontend.h2d": "serve.transcribe",
    "frontend.resample": "serve.transcribe", "frontend.resample_table": "frontend.resample",
    "frontend.windows": "serve.transcribe", "serve.cast_model": "serve.transcribe",
    "model.forward": "serve.transcribe", "ops.stitch": "serve.transcribe",
    "eventize": "", "eventize.kernel": "eventize", "eventize.fetch": "eventize",
    "eventize.host": "eventize",
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def read_trace(path: Path) -> dict:
    """The program spans and the device's idle gaps of one traced
    recording."""
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") in PARENT
             and e.get("cat") in ("cpu_op", "user_annotation")]
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    faults = []
    for e in spans:
        parent = PARENT[e["name"]]
        if not parent:
            continue
        request = e["args"].get("request")
        around = [p for p in by_name.get(parent, ())
                  if p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
                  and request is not None and p["args"].get("request") == request]
        if not around:
            faults.append(f"{e['name']} lies in no {parent} of its request")
    (root,) = by_name["serve.transcribe"]
    children = sum(e["dur"] for e in spans if PARENT[e["name"]] == "serve.transcribe")
    lo = root["ts"]
    hi = max(e["ts"] + e["dur"] for e in by_name["eventize"])
    busy = []
    for start, end in sorted(device):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if busy and start <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], end)
        else:
            busy.append([start, end])
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    gaps, idle_by_span = [], {}
    for start, end in zip(edges[0::2], edges[1::2]):
        if end <= start:
            continue
        mid = (start + end) / 2
        inside = [e for e in spans if e["ts"] <= mid <= e["ts"] + e["dur"]]
        name = min(inside, key=lambda e: e["dur"])["name"] if inside else "outside_any_span"
        gaps.append((name, (end - start) / 1e3))
        idle_by_span[name] = idle_by_span.get(name, 0.0) + (end - start) / 1e3
    return {
        "spans": {n: [round(e["dur"] / 1e3, 3) for e in es] for n, es in by_name.items()},
        "requests": {n: sorted({e["args"].get("request") for e in es})
                     for n, es in by_name.items()},
        "faults": faults,
        "transcribe_ms": root["dur"] / 1e3,
        "transcribe_self_share": (root["dur"] - children) / root["dur"],
        "busy_ms": sum(e - s for s, e in busy) / 1e3,
        "window_ms": (hi - lo) / 1e3,
        "idle_ms_by_span": dict(sorted(idle_by_span.items(), key=lambda kv: -kv[1])),
        "longest_gaps_ms": sorted(gaps, key=lambda g: -g[1])[:10],
    }


def ns_per_span(count: int, device: torch.device) -> dict:
    """Host ns per ``with span(...): pass``: off, inside ``recording()`` and
    under a profiler (CPU and, on the card, CUDA activities), beside the
    empty loop."""
    def loop(n: int) -> float:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("cost"):
                pass
        return (time.perf_counter_ns() - t0) / n

    t0 = time.perf_counter_ns()
    for _ in range(count):
        pass
    empty = (time.perf_counter_ns() - t0) / count
    out = {"empty_loop": empty, "off": loop(count)}
    with profiling.recording():
        out["recording"] = loop(count)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities, record_shapes=True):
        out["profiler"] = loop(count // 10)
    profiling.reset()
    return out


def measure(cell: str, config: dict, mix: dict, seed: int, device: torch.device) -> dict:
    server = serve.Server(config, mix, seed, device)
    rung = max(range(len(server.ladder.lengths)), key=lambda r: server.ladder.lengths[r])
    samples = server.audio[0, rung]

    def once():
        stitched = server.infer.transcribe_samples_fused(
            server.model, server.cfg, samples, server.rope, mix["src_rate"],
            server.cfg.data.model_audio_length, mix["overlap_s"])
        _sync(device)
        notes = extract_events(stitched)
        return stitched, notes

    once()   # warm: this batch shape's algorithms
    profiling.reset()
    stitched, notes = once()
    if profiling.summary():
        raise AssertionError("spans recorded with tracing off")
    with profiling.recording():
        recorded = once()
    host_ms = {n: {"ms": s["total_ns"] / 1e6, "self_ms": s["self_ns"] / 1e6, **s["counts"]}
               for n, s in profiling.summary().items()}
    with tempfile.TemporaryDirectory() as trace_dir:   # tens of MB: read, not kept
        with profiling.trace(trace_dir):
            traced = once()
        (path,) = Path(trace_dir).glob("*.json")
        reading = dict(read_trace(path), trace_bytes=path.stat().st_size)
    same = {kind: bool(torch.equal(s, stitched)) and n == notes
            for kind, (s, n) in (("recording", recorded), ("trace", traced))}
    profiling.reset()
    return {"cell": cell, "seconds": server.ladder.lengths[rung], "notes": len(notes),
            "identical_to_off": same, "host_ms_recording": host_ms, "trace": reading}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--cells", nargs="+", default=["serve-f32", "serve-bf16"])
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--span-loops", type=int, default=200_000)
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    bench = manifest.load()
    results = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               "torch": torch.__version__, "cells": []}
    ok = True
    for cell in args.cells:
        _work, config, mix = manifest.cell(bench, cell)
        r = measure(cell, config, mix, args.seed, device)
        results["cells"].append(r)
        t = r["trace"]
        # No cast where the dtypes agree; on the card the resampler's kernel
        # builds no index table (the plain path's span).
        expected = set(PARENT) - (
            {"serve.cast_model"} if config["precision"]["compute_dtype"] == "f32" else set()) - (
            {"frontend.resample_table"} if device.type == "cuda" else set())
        missing, unexpected = expected - set(t["spans"]), set(t["spans"]) - expected
        ok &= (all(r["identical_to_off"].values()) and not t["faults"] and not missing
               and not unexpected)
        print(f"{cell}: {r['seconds']:.0f} s recording, {r['notes']} notes; outputs identical "
              f"to spans off {r['identical_to_off']}; spans missing {sorted(missing)}, "
              f"unexpected {sorted(unexpected)}; faults "
              f"{t['faults']}; serve.transcribe {t['transcribe_ms']:.3f} ms in the trace, self "
              f"{100 * t['transcribe_self_share']:.2f} %; busy {t['busy_ms']:.3f} of "
              f"{t['window_ms']:.3f} ms; idle by span {t['idle_ms_by_span']}", flush=True)
        print(f"{cell}: host ms inside recording(): {r['host_ms_recording']}", flush=True)
    results["ns_per_span"] = ns_per_span(args.span_loops, device)
    print(f"ns per span: {results['ns_per_span']}", flush=True)
    (out / "serve_spans.json").write_text(json.dumps(results, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
