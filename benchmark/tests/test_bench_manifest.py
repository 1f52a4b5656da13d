"""``BENCHMARK.json`` and the files it names: every name resolves, every
metric is reported where it says, and the contract's limits hold."""

import json
import re
from pathlib import Path

import pytest

from benchmark.harness import core

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = ([c["name"] for c in MANIFEST["configs"]]
             + [w["name"] for w in MANIFEST["workloads"]]
             + [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = ([w["why"] for w in MANIFEST["workloads"]]
             + [c["source"] for c in MANIFEST["configs"]]
             + [m["layer"] for m in MANIFEST["per_layer"]])
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("w", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    cell = core.load_cell(w["name"])
    assert cell.workload["config"] == w["config"] and cell.workload["traffic"] == w["traffic"]
    assert cell.workload["chips"] == w["chips"] == 1 and cell.workload["why"] == w["why"]
    core.load_driver(cell.traffic["driver"])
    conf = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    assert conf["file"] == f"benchmark/configs/{w['config']}.json"
    assert (ROOT / conf["file"]).is_file()
    assert conf["reduced"] == cell.config["reduced"] and conf["source"] == cell.config["source"]


@pytest.mark.parametrize("w", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_reports(w):
    """Each cell reports ``setup_s``, another end-to-end metric and a
    per-layer metric; each per-layer metric it reports moves one of its
    end-to-end metrics."""
    cell = core.load_cell(w["name"])
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    mine = set(cell.workload["end_to_end"])
    assert mine and mine <= set(e2e) and "setup_s" in e2e
    for name in mine:
        assert w["name"] in e2e[name].get("workloads", [w["name"]])
    layers = [m for m in MANIFEST["per_layer"] if w["name"] in m["workloads"]]
    assert layers
    for m in layers:
        assert m["moves"] in mine


def test_metric_files_match_manifest():
    files = core.metrics()
    assert set(files) == {m["name"] for m in MANIFEST["per_layer"]}
    for m in MANIFEST["per_layer"]:
        f = files[m["name"]]
        assert (f.unit, f.layer, f.moves, f.workloads) == (
            m["unit"], m["layer"], m["moves"], m["workloads"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
