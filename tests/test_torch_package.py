"""Package rules of the PyTorch port.

* Every module of ``prior_diffuse_tpu_torch`` imports with jax, flax, yaml
  and the JAX package blocked: the machine with the GPU has none of them,
  and this test process imports jax (``conftest.py``), so an accidental
  import would pass every other test here.
* ``chip_smoke.py`` refuses to run without a CUDA card: it exits non-zero
  within seconds and prints no ``"ok": true`` line.
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml",
               "prior_diffuse_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import prior_diffuse_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print(len(names))
""")


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20  # every module was walked


def test_chip_smoke_fails_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "cuda" in proc.stderr.lower()
