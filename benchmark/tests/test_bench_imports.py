"""Nothing the harness imports has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``prior_diffuse_tpu`` (the port, ``prior_diffuse_tpu_torch``,
is another name), and the reference imports nothing of the port."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                      "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    got = run(
        "import json, sys, torch\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from conftest import SMALL, SEED\n"
        "from benchmark.harness import core\n"
        "core.metrics()\n"
        "r = core.run_cell('diffunet.files-f32', SEED, 0.1, True, device='cpu',\n"
        "                  traffic_overrides=SMALL['diffunet.files-f32'])\n"
        "print(json.dumps({'bad': core.forbidden_modules(), 'correct': r['correct'],\n"
        "                  'port': 'prior_diffuse_tpu_torch' in sys.modules}))\n")
    assert got == {"bad": [], "correct": True, "port": True}


def test_the_reference_and_the_count_import_nothing_of_the_program():
    got = run(
        "import json, sys\n"
        "import benchmark.reference.models, benchmark.reference.dsp\n"
        "import benchmark.reference.serve, benchmark.reference.train\n"
        "import benchmark.reference.precision, benchmark.count.flops\n"
        "import benchmark.count.stages\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules\n"
        "                         if m.split('.')[0].startswith(('prior', 'jax', 'flax'))})))\n")
    assert got == []
