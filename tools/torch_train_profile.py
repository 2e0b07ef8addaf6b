#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time on one GPU.

    python3 tools/torch_train_profile.py [--out DIR] [--dropout-rate RATE]
                                         [--cnn-bwd-kernel on|off|turns]

Takes the training steps of chip_smoke.py's training phases, through that
script's own set-up: the default model from seed 0, bf16 compute over f32
parameters, one seeded batch of the configuration's batch and minibatch
sizes; dropout at the configuration's rate (0.1, the reference-parity step)
or, with `--dropout-rate 0`, dropout-free; the ConvNeXt stages 5 and 6
differentiated by the fused stage-backward kernel (`on`, the default
configuration), by autograd (`off`), or both in turns in one call (`turns`:
off, on, on, off, each from a fresh model).  After two warm-up steps it
prints, with the card's name and power limit:
  * the host wall and the device time (CUDA events) of three whole steps;
  * forward, backward and optimizer of one minibatch, each as host wall to
    enqueue, and device time by CUDA events;
  * from one step under torch.profiler: the device's busy time (union of
    kernel and copy intervals), its idle share of the step, the number of
    device operations, and the kernels that take the most device time.
Writes the same as JSON to DIR/torch_train_profile.json, or
torch_train_profile_dropout_free.json at rate 0, with `_autograd_cnn` or
`_turns` (a list, one entry per turn) before `.json` for `off` and `turns`
(default DIR: build/smoke/ in the checkout).  Needs one CUDA device and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from audio_to_midi_tpu_torch.config import DEFAULT_CONFIG, DTYPES  # noqa: E402
from audio_to_midi_tpu_torch.models import model as model_lib  # noqa: E402
from audio_to_midi_tpu_torch.train import loss as loss_lib  # noqa: E402


def timed(fn) -> tuple[float, float]:
    """(host ms to enqueue, device ms by CUDA events) of fn(), the card idle before."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return host, start.elapsed_time(end)


def profile_steps(card: str, dropout_rate: float, cnn_bwd_kernel: bool) -> dict | None:
    """One configuration's steps taken apart, printed and returned."""
    model = chip_smoke.seeded_model(model_lib, DEFAULT_CONFIG).train()
    cfg, rope, optimizer, step, audio, labels = chip_smoke.training_setup(
        model_lib, DEFAULT_CONFIG, model, dropout_rate, cnn_bwd_kernel)
    model_cfg = cfg.model
    compute_dtype = DTYPES[cfg.precision.compute_dtype]
    generator = torch.Generator().manual_seed(7)  # the steps' dropout, unused at rate 0
    for _ in range(2):
        step(model, audio, labels, 1.0, generator)

    result = {"card": card, "batch": audio.shape[0] * audio.shape[1],
              "minibatch": audio.shape[1], "dropout_rate": dropout_rate,
              "cnn_bwd_kernel": cnn_bwd_kernel, "compute_dtype": cfg.precision.compute_dtype}
    print(f"dropout rate {dropout_rate}, cnn_bwd_kernel {cnn_bwd_kernel}", flush=True)

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, device_ms = timed(lambda: step(model, audio, labels, 1.0, generator))
        walls.append(((time.perf_counter() - t0) * 1e3, device_ms))
    result["step_ms"] = [{"wall": w, "device_events": d} for w, d in walls]
    print("steps (wall ms, device ms): " + ", ".join(f"({w:.1f}, {d:.1f})" for w, d in walls))

    # One minibatch taken apart.  Here each phase starts on an idle card and
    # its host time is the time to enqueue it.  The optimizer is the step's:
    # the chain with its guard on the card.
    for p in optimizer.params:
        p.grad = None
    holder = {}

    def forward():
        with torch.enable_grad():
            holder["loss"] = loss_lib.batch_loss(
                model, model_cfg, audio[0], labels[0], rope, 1.0, compute_dtype,
                generator=torch.Generator(device="cuda").manual_seed(8))

    phases = {"forward": timed(forward), "backward": timed(lambda: holder["loss"].backward())}
    grads = [p.grad for p in optimizer.params]
    valid = torch.ones((), dtype=torch.bool, device=grads[0].device)
    phases["optimizer"] = timed(lambda: optimizer.apply(optimizer.update(grads, valid)))
    result["minibatch_phases_ms"] = {k: {"host_enqueue": h, "device_events": d}
                                     for k, (h, d) in phases.items()}
    for k, (h, d) in phases.items():
        print(f"{k}: host enqueue {h:.1f} ms, device {d:.1f} ms")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(model, audio, labels, 1.0, generator)
        torch.cuda.synchronize()
    traced_wall = (time.perf_counter() - t0) * 1e3
    device_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device_events:
        print("torch.profiler recorded no device events", file=sys.stderr)
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_events)
    busy_us, cur_start, cur_end = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_end:
            busy_us += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    busy_us += cur_end - cur_start
    span_ms = (spans[-1][1] - spans[0][0]) / 1e3
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in device_events:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    result["profiled_step"] = {
        "wall_ms_traced": traced_wall, "device_span_ms": span_ms, "device_busy_ms": busy_us / 1e3,
        "device_idle_share_of_span": 1.0 - busy_us / 1e3 / span_ms,
        "device_operations": len(device_events),
        "top_kernels": [{"name": n[:120], "ms": us / 1e3, "count": c,
                         "share_of_busy": us / busy_us} for n, (us, c) in top],
    }
    print(f"profiled step: wall {traced_wall:.1f} ms (traced), device span {span_ms:.1f} ms, busy "
          f"{busy_us / 1e3:.1f} ms, idle share {1.0 - busy_us / 1e3 / span_ms:.3f}, "
          f"{len(device_events)} device operations")
    for n, (us, c) in top:
        print(f"  {us / 1e3:8.2f} ms {us / busy_us:6.1%} x{c:<5d} {n[:100]}")

    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=chip_smoke.WORK)
    ap.add_argument("--dropout-rate", type=float,
                    default=DEFAULT_CONFIG.model.transformer_dropout_rate)
    ap.add_argument("--cnn-bwd-kernel", choices=("on", "off", "turns"), default="on")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device available", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(card, flush=True)
    turns = {"on": (True,), "off": (False,), "turns": (False, True, True, False)}
    results = [profile_steps(card, args.dropout_rate, kernel)
               for kernel in turns[args.cnn_bwd_kernel]]
    if any(r is None for r in results):
        return 1
    args.out.mkdir(parents=True, exist_ok=True)
    name = "torch_train_profile" + ("" if args.dropout_rate else "_dropout_free") + {
        "on": "", "off": "_autograd_cnn", "turns": "_turns"}[args.cnn_bwd_kernel] + ".json"
    (args.out / name).write_text(json.dumps(
        results if args.cnn_bwd_kernel == "turns" else results[0], indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
