"""The readings that a cell's limits are set from, in one process on the card.

    python3 -m portbench.calibrate --workload serve-f32 --seeds 1 2 ... \
        --control-seeds 1 2 3 --out DIR

For every seed: the program serves one cycle of the ladder (every length,
the longest among them), the sample a run would check is drawn from it, and
the output check's numbers are read against the f32 reference.  For every
control seed the same is read of the control: the reference in the
configuration's ``control`` precision (``reference/precision.py``) in the
program's place, on the same recordings.  Each reading is also judged
against the configuration's limits.  Writes
``DIR/calibrate_<workload>.json`` and prints one line per reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import sys
import time
from pathlib import Path

import torch

from . import check, manifest
from .drivers import serve, train


def _read(config: dict, mix: dict, seed: int, device, control: bool) -> dict:
    return (_read_train if mix["driver"] == "train" else _read_serve)(
        config, mix, seed, device, control)


def _read_train(config: dict, mix: dict, seed: int, device, control: bool) -> dict:
    """One seed's readings: the program's set-up and checked steps as a run
    makes them (``train.program``, with a window of one step), compared by
    the run's own ``check.train_readings``; with ``control`` also the
    control's and the half-batch fault's."""
    _, o = train.program(config, mix, seed, 0.0, False, device)
    t0 = time.perf_counter()
    reading = {"seed": seed, "loss": o["program"]["loss"]}
    reading.update(check.train_readings(o["program"], o["rows"], o["draws"], o["initial"],
                                        config, mix, device, control=control))
    reading["reference_s"] = time.perf_counter() - t0
    reading["correct"] = {side: check.judge(reading[side], config["check"]["train"], 0)[0]
                          for side in ("program", "control", "half_batch") if side in reading}
    return reading


def _read_serve(config: dict, mix: dict, seed: int, device, control: bool) -> dict:
    """One seed's readings: the program serves one cycle of the ladder, and
    the sample a run would check is drawn from it and compared by the same
    functions a run calls (``check.sample``, ``check.readings``)."""
    server = serve.Server(config, mix, seed, device)
    outputs = {}
    for index in range(len(server.ladder.lengths)):
        req = server.ladder.request(index)
        stitched, notes = server.serve(req)
        outputs[index] = (req, stitched, notes)
    notes_per_s = (sum(len(n) for _, _, n in outputs.values())
                   / sum(r.seconds for r, _, _ in outputs.values()))
    requests, program = check.sample(outputs, seed, mix["check_sample"])
    params, audio = server.params, server.audio
    del outputs, server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reading = {"seed": seed, "sample_s": [r.seconds for r in requests], "notes_per_s": notes_per_s}
    reading.update(check.readings(program, requests, params, config, mix, audio, device,
                                  control=control))
    reading["correct"] = {side: check.judge(reading[side], config["check"]["serve"], 0)[0]
                          for side in ("program", "control") if side in reading}
    return reading


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", type=Path, required=True)
    args = p.parse_args(argv)
    work, config, mix = manifest.cell(manifest.load(), args.workload)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    readings = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        r = _read(config, mix, seed, device, control=seed in args.control_seeds)
        readings.append(r)
        print(json.dumps(r), flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / f"calibrate_{args.workload}.json").write_text(json.dumps(
        {"workload": args.workload, "control": config["control"], "readings": readings,
         "card": torch.cuda.get_device_name(device)}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
