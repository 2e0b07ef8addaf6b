"""One run of one benchmark cell on the card this process finds.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
``breakdown`` (``--trace 1``) and last ``checks``, each number of the output
check beside its limit.  The checks are also the last lines of standard
error.  Exits with a code other than 0, and prints no result, without a CUDA
device (or with fewer than the cell asks for), without the program, or when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "audio_to_midi_tpu")
log = logging.getLogger("portbench")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``audio_to_midi_tpu_torch`` passes."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _cache_dirs() -> None:
    """Every compiler cache the process might use, at fixed paths in the
    checkout.  The port's own kernels build into build/torch_kernels/."""
    cache = manifest.BENCH / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def _number(x):
    return x if isinstance(x, int) or math.isfinite(x) else None


def result_line(work: dict, config: dict, out: dict, traced: bool, bench: dict,
                device: dict) -> dict:
    """The result object of a run, from the driver's output ``out``."""
    name = work["name"]
    metrics = {}
    if not traced:
        for m in manifest.end_to_end(bench, name):
            metrics[m["name"]] = {"value": _number(out["end_to_end"][m["name"]]),
                                  "unit": m["unit"]}
    else:
        ctx = dict(out, work=work, config=config)
        for m in manifest.per_layer(bench, name):
            value = manifest.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if traced and out["trace"] is not None:
        summary = out["trace"]
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        line["breakdown"] = {"device_ops": [[n[:100], t] for n, t in summary["device_ops"]],
                             "idle_gaps": [[n, t] for n, t in summary["idle_gaps"]]}
    line["checks"] = {k: {"value": _number(c["value"]), "limit": c["limit"]}
                      for k, c in out["checks"].items()}
    return line


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = manifest.load()
    work, config, mix = manifest.cell(bench, args.workload)
    _cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"portbench: needs {work['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}; no result",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log.info("card: %s (name, power.limit); peaks: bf16 989 TFLOP/s, f32 products as "
             "3xTF32 against TF32's 495 TFLOP/s, HBM 3.35 TB/s", _card())
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    out = driver.run(config, mix, args.seed, args.seconds, bool(args.trace), device, T_PROCESS)

    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {loaded}; no result", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    line = result_line(work, config, out, bool(args.trace), bench, dev)
    log.info("sampled recordings (s): %s; counters %s", out["sample"], out["counters"])
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
