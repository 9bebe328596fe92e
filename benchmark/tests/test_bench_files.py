"""BENCHMARK.json and the files it names: every cell and configuration file
loads, names and units use the allowed characters, each cell's file agrees
with its entry, every per-layer metric has its reader, and every cell reports
set-up, another end-to-end metric and a per-layer metric."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

CHECKOUT = Path(__file__).resolve().parents[2]
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in BENCH["paths"])
    assert len((CHECKOUT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    for entry in BENCH["configs"] + BENCH["workloads"] + METRICS:
        assert NAME.match(entry["name"]), entry["name"]
    for metric in METRICS:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
    for config in BENCH["configs"]:
        assert all(NAME.match(k) for k in config["reduced"]) and len(config["reduced"]) <= 16
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_agrees(cell):
    entry = next(c for c in BENCH["workloads"] if c["name"] == cell)
    loaded = harness.load_cell(cell)
    assert loaded["config"] == entry["config"] and loaded["chips"] == entry["chips"] == 1
    assert loaded["why"] == entry["why"]
    assert cell == f"{entry['config']}.{entry['traffic']}"
    assert (harness.ROOT / "traffic" / f"{loaded['kind']}.py").exists()


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_loads(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"] == f"benchmark/configs/{config}.json"
    loaded = harness.load_config(config)
    assert loaded["name"] == config and loaded["source"] == entry["source"]
    assert loaded["reduced"] == entry["reduced"]
    assert any(c["config"] == config for c in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_its_metrics(cell):
    e2e = [m for m in BENCH["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    per_layer = harness.per_layer_metrics(BENCH, cell)
    assert per_layer
    for metric in per_layer:
        assert metric["moves"] in names


def test_per_layer_metrics_have_readers():
    layers = {}
    for metric in BENCH["per_layer"]:
        assert (harness.ROOT / "metrics" / f"{metric['name']}.py").exists(), metric["name"]
        assert metric.get("workloads") and set(metric["workloads"]) <= set(CELLS), metric["name"]
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        layers.setdefault(metric["layer"], set()).add(metric["name"])
    for metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace") and 0 < metric["bound"] <= 0.25


def test_command_names_only_paths():
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    for word in BENCH["command"][1:]:
        assert any(word.startswith(p + "/") for p in BENCH["paths"])
