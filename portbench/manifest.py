"""``BENCHMARK.json`` and the files it names: a cell's configuration and
traffic mix, the metrics it reports, and each per-layer metric's reader
(``metrics/<name>.py``)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic mix) of the cell ``name``."""
    workloads = {w["name"]: w for w in manifest["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(workloads)}")
    work = workloads[name]
    entry = {c["name"]: c for c in manifest["configs"]}[work["config"]]
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{work['traffic']}.json").read_text())
    return work, config, mix


def _applies(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def end_to_end(manifest: dict, name: str) -> list[dict]:
    return [m for m in manifest["end_to_end"] if _applies(m, name)]


def per_layer(manifest: dict, name: str) -> list[dict]:
    """The per-layer metrics of a cell: those that list it, and those that
    list no cell and move an end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(manifest, name)}
    return [m for m in manifest["per_layer"]
            if name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in reported)]


def reader(name: str):
    """The module ``metrics/<name>.py``: its ``read(ctx)`` gives the value,
    or None where the run has nothing to read."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
