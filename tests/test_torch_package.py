"""Package rules of the PyTorch port.

* Every module of ``prior_diffuse_tpu_torch`` imports with jax, flax, optax,
  orbax, yaml and the JAX package blocked, the training, bf16 serving,
  diffusion-mode, prior, GRN, bf16-training, tooling, data-parallel,
  roofline and research-driver slices' included (the tooling and the
  drivers import matplotlib and wandb only when they draw or mirror), and ``conf/diff.yml``,
  ``conf/gcrn.yml``, ``conf/dbaiat.yml`` and ``conf/grn.yml`` load so: the machine with the GPU has none of
  them, and this test process imports jax (``conftest.py``), so an
  accidental import would pass every other test here.
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
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in BLOCKED + ("matplotlib", "wandb"))
    assert not leaked, leaked
    from prior_diffuse_tpu_torch.config import load_experiment
    exp = load_experiment("conf/diff.yml")
    assert (exp.train.batch_size, exp.optim_ddpm.lr) == (6, 0.0002), exp
    from prior_diffuse_tpu_torch.models import model_class
    for conf, cls in (("gcrn", "GCRN"), ("dbaiat", "AiaComplexTransRI"), ("grn", "GRN")):
        assert model_class(load_experiment(f"conf/{conf}.yml").model.name).__name__ == cls
    print(" ".join(names))
""")

# the modules of the training slice, each of which must be walked above
TRAINING_SLICE = [
    "cli", "config", "losses", "data.dataset", "data.synthetic", "data.wavio",
    "diffusion.qsample", "metrics.compare", "metrics.composite", "metrics.pesq",
    "metrics.pesq_np", "metrics.stoi", "serving.enhance", "training.base",
    "training.checkpoint", "training.ddpm_trainer", "training.optim",
    "training.plateau", "utils.logging",
]


# the modules of the bf16 serving slice
BF16_SERVING_SLICE = ["models.fused_forward", "ops.cuda.convblock", "serving.enhancer",
                      "serving.enhance", "serving.streaming", "diffusion.sampler"]

# the modules of the deltamu / conditional modes and the checkpoint bridge
MODES_SLICE = ["models.diffunet", "convert", "diffusion.sampler", "serving.enhancer",
               "training.base", "training.checkpoint", "training.ddpm_trainer"]


# the modules of the GCRN / DB-AIAT priors and ComplexTrainer
PRIORS_SLICE = ["models", "models.layers", "models.gcrn", "models.dbaiat", "convert",
                "serving.enhance", "serving.enhancer", "training.complex_trainer",
                "training.ddpm_trainer", "cli"]

# the modules of GRN with MagTrainer, DiffWave and the bf16 serving of every prior
GRN_SLICE = ["models.grn", "models.diffwave", "models", "convert", "training.base",
             "training.mag_trainer", "serving.enhance", "serving.enhancer", "cli"]

# the modules of bf16 training (compute_dtype: bfloat16) in the three trainers
BF16_TRAIN_SLICE = ["models.precision", "models.layers", "models.fused_forward",
                    "diffusion.sampler", "serving.enhancer", "serving.enhance",
                    "training.ddpm_trainer", "training.complex_trainer",
                    "training.mag_trainer", "metrics.compare", "config", "cli"]

# the modules of the train-loop tooling: the native train loader,
# --profile-steps, --draw, --wandb and the compare command line
TOOLING_SLICE = ["runtime", "runtime.native", "data.dataset", "utils.profiler", "viz",
                 "utils.logging", "metrics.compare", "training.ddpm_trainer", "cli"]

# the modules of data parallelism (parallel/ and what takes a group)
PARALLEL_SLICE = ["parallel", "parallel.distributed", "parallel.mesh", "models.layers",
                  "losses", "data.dataset", "diffusion.qsample", "serving.enhancer",
                  "serving.enhance", "training.base", "training.ddpm_trainer",
                  "training.complex_trainer", "training.mag_trainer", "utils.logging", "cli"]

# the modules of the static roofline and the trainers' step-to-step timer
ROOFLINE_SLICE = ["utils.roofline", "utils.profiler", "training.ddpm_trainer",
                  "training.complex_trainer", "training.mag_trainer"]


# the research drivers: a counterpart of each script of the repository's
# scripts/ that is not left out by design (ROADMAP.md, "Not ported")
SCRIPTS_SLICE = ["scripts", "scripts._report", "scripts._setup", "scripts.train_demo",
                 "scripts.eval_schedules", "scripts.diagnose_ddpm",
                 "scripts.probe_predictability", "scripts.cal_metrics", "scripts.cal_params",
                 "scripts.analyze_residual", "scripts.draw", "scripts.gaussian_distribution",
                 "scripts.show_wav_len"]


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    walked = set(proc.stdout.split())
    assert len(walked) >= 50  # every module was walked
    missing = [m for m in (TRAINING_SLICE + BF16_SERVING_SLICE + MODES_SLICE + PRIORS_SLICE
                           + GRN_SLICE + BF16_TRAIN_SLICE + TOOLING_SLICE + PARALLEL_SLICE
                           + ROOFLINE_SLICE + SCRIPTS_SLICE)
               if f"prior_diffuse_tpu_torch.{m}" not in walked]
    assert not missing, missing


def test_chip_smoke_fails_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "cuda" in proc.stderr.lower()
