"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = manifest.load()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", METRICS + BENCH["configs"] + BENCH["workloads"],
                         ids=lambda e: e["name"])
def test_names_units_and_text(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique():
    for group in (METRICS, BENCH["configs"], BENCH["workloads"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_end_to_end_bounds():
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert names["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_name_their_files_and_report_enough(work):
    assert work["chips"] in (1, 4)
    _, config, mix = manifest.cell(BENCH, work["name"])
    assert config["name"] == work["config"]
    limits = config["check"][mix["driver"]]
    if mix["driver"] == "serve":
        assert set(limits) <= {"prob_gap", "prob_gap_mean", "event_mismatch"}
        assert limits["event_mismatch"] == 0
    else:
        assert set(limits) <= {"loss_gap", "grad_norm_gap", "change_norm_gap"}
    reported = [m["name"] for m in manifest.end_to_end(BENCH, work["name"])]
    assert "setup_s" in reported and len(reported) >= 2
    assert manifest.per_layer(BENCH, work["name"])
    assert (manifest.BENCH / "drivers" / f"{mix['driver']}.py").is_file()


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(config):
    assert config["file"].startswith("portbench/")
    data = json.loads((manifest.ROOT / config["file"]).read_text())
    assert data["source"] == config["source"]
    assert config["reduced"] == []


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_readers_declare_what_the_manifest_says(metric):
    module = manifest.reader(metric["name"])
    assert (module.LAYER, module.UNIT, module.SOURCE, module.MOVES) == (
        metric["layer"], metric["unit"], metric["source"], metric["moves"])
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert module.read({"trace": None, "counters": {"windows": 0, "window_s": 0.0},
                        "spans": type("S", (), {"count": {}, "total": {}})(),
                        "config": json.loads((manifest.BENCH / "configs" / "a2m-f32.json").read_text())}) is None
