"""``run.py`` without a card: it exits non-zero and prints no result; it
never falls back to the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def test_run_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "diffunet.files-f32",
                          "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_names_an_unknown_cell():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "no.such-cell",
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
