"""A cell (with its traffic mix), a configuration, a driver and a
per-layer metric added as files alone are found by name, with no file
edited."""

import json
import shutil
from pathlib import Path

import pytest

from benchmark.harness import core
from conftest import SEED, SMALL

BENCH = Path(__file__).resolve().parents[1]

METRIC = '''UNIT = "files/batch"
LAYER = "serving front end"
MOVES = "audio_s_per_s"
WORKLOADS = ["extra.files-small"]


def read(t):
    return t.counts["files"] / t.counts["batches"] if t.counts.get("batches") else None
'''
DRIVER = '''from benchmark.drivers.files import Driver as Files


class Driver(Files):
    def trace_counts(self):
        return dict(super().trace_counts(), files=self.attempted)
'''


@pytest.fixture
def copy(tmp_path, monkeypatch):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    monkeypatch.setattr(core, "BENCH", root)
    return root


def test_new_files_are_picked_up(copy):
    conf = json.loads((copy / "configs" / "diffuse-diffunet.json").read_text())
    conf["source"] = "a second deployment of the same nets"
    (copy / "configs" / "extra-config.json").write_text(json.dumps(conf))
    (copy / "drivers" / "extra_driver.py").write_text(DRIVER)
    cell = json.loads((copy / "workloads" / "diffunet.files-f32.json").read_text())
    mix = dict(cell["mix"], driver="extra_driver", **SMALL["diffunet.files-f32"])
    cell.update(config="extra-config", traffic="extra-mix", mix=mix, why="a test cell")
    (copy / "workloads" / "extra.files-small.json").write_text(json.dumps(cell))
    (copy / "metrics" / "files_per_batch.extra.py").write_text(METRIC)

    assert core.load_cell("extra.files-small").config["source"].startswith("a second")
    assert core.metrics()["files_per_batch.extra"].workloads == ["extra.files-small"]
    r = core.run_cell("extra.files-small", SEED, 0.1, True, device="cpu")
    assert r["correct"]
    assert r["metrics"]["files_per_batch.extra"]["value"] == pytest.approx(2.0)
    assert "mfu.files" not in r["metrics"]  # the old cells' metrics stay with them
