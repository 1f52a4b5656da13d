"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The program's build caches live inside
the checkout at fixed paths (``.bench_cache/``; the port builds its
kernels into ``prior_diffuse_tpu_torch/build/``), so only a checkout's
first run builds.  Exits non-zero, printing no result, without the CUDA
devices the cell asks for.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
