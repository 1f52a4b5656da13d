#!/usr/bin/env python3
"""What moves the JAX reference of ``tests/test_torch_train_step.py``: its
jitted float32 DDPM step, compiled afresh or loaded from JAX's persistent
compile cache, and on its input's float32 rounding (CPU, JAX only).

    python3 tools/f32_step_probe.py cache [CONFIG ...]
    python3 tools/f32_step_probe.py bounds [CONFIG ...]
    python3 tools/f32_step_probe.py run CONFIG OUT.npz [--cache DIR|off] [--seed S]

``run`` takes the test's one step of ``CONFIG`` (a key of the test's
``CONFIGS``: its corpus, batch, initial state and step key) through the JAX
trainer's jitted ``_train_step`` in this process and writes every output
leaf (new parameters, BatchNorm statistics, Adam state, losses, group
norms) to ``OUT.npz``.  ``--cache off`` compiles with the persistent cache
disabled; ``--cache DIR`` uses ``DIR`` as the cache (loading an entry
there, else compiling and writing one).  ``--seed S`` multiplies both
batches by ``1 + 1e-7 N(0, 1)`` drawn from ``S`` first.  The environment
is the tests' (``tests/conftest.py``: 8 virtual CPU devices), so a cache
entry written here is one the tests load.

``cache`` runs, each in a process of its own: the step with the cache off
twice; into an empty cache directory (cold) and from it again (warm);
with the cache off and ``--xla_cpu_max_isa=AVX2`` (the executable another
CPU type would compile); and the step on the batch times ``1 + 1e-7 N(0,
1)`` (seeds 1, 2).  Against the first, it prints for each run the number
of output leaves that differ in any bit and the distances the test bounds:
losses (relative), the group norms (the ``rtol`` each needs beyond the
test's ``1e-6 x`` the net's largest norm), the BatchNorm statistics (the
``rtol`` they need beyond ``1e-7``), each net's same-sign steady updates
(relative L2) and their Adam moments.

``bounds`` builds the test's ``make_step_pair`` for each configuration
(by default those of its ``SPREAD``) in this process, with the tests'
persistent cache, and prints JAX's two spread samples, the bounds they
set, the port's distances (also with torch on 1, 4 and 8 threads; the
test's worker runs it on 2) and each wrong port's of the test's
``CONTROLS`` (``wrong_port``), in the test's terms.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = ("dis", "ddpm")


def _env() -> None:
    """The tests' JAX environment (``tests/conftest.py``)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_NUM_CPU_DEVICES"] = "8"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()


def run(config: str, out: str, cache: str = "off", seed: int = None) -> None:
    """``run``'s step, written to ``out``."""
    _env()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    if cache == "off":
        jax.config.update("jax_enable_compilation_cache", False)
    else:
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    import prior_diffuse_tpu.config as jcfg
    from prior_diffuse_tpu.data import synthetic
    from prior_diffuse_tpu.parallel.mesh import make_mesh
    from prior_diffuse_tpu.training import ComplexDDPMTrainer
    from test_torch_train_step import CONFIGS, _batch, _exp, _perturbed

    flags, diff_kw, _ = CONFIGS[config]
    with tempfile.TemporaryDirectory() as tmp:
        corpus = synthetic.write_corpus(f"{tmp}/corpus", n_train=2, n_test=2, min_len=6000,
                                        max_len=9000, seed=5)
        jrun = jcfg.RunConfig(assets=f"{tmp}/jax", doc="t", data_root=corpus, **flags)
        jtr = ComplexDDPMTrainer(jrun, _exp(jcfg, diff_kw), mesh=make_mesh(dp=1))
        batch = _batch(corpus)
        wavs = [batch.noisy, batch.clean] if seed is None else _perturbed(batch, seed)
        before = {f"start {n}": _flat(jtr.state[n]["params"]) for n in NETS}
        start = time.perf_counter()
        step = jtr._train_step.lower(jtr.state, *jtr.put_batch(*wavs, batch.frame_nums),
                                     jax.random.PRNGKey(11)).compile()
        compiled = time.perf_counter() - start
        outs = step(jtr.state, *jtr.put_batch(*wavs, batch.frame_nums),
                    jax.random.PRNGKey(11))
    leaves = jax.tree_util.tree_flatten_with_path(outs)[0]
    np.savez(out, **before, **{jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves})
    print(f"{config} cache={cache} seed={seed}: compiled or loaded in {compiled:.1f} s",
          flush=True)


def _flat(tree) -> np.ndarray:
    import jax

    return np.concatenate([np.asarray(a).ravel() for a in jax.tree.leaves(tree)])


def _load(path: str) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _of(leaves: dict, prefix: str) -> np.ndarray:
    keys = sorted(k for k in leaves if k.startswith(prefix))
    return np.concatenate([leaves[k].ravel().astype(np.float64) for k in keys])


def distances(got: dict, want: dict) -> dict:
    """How far the step ``got`` sits from ``want``, in the test's terms."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from test_torch_train_step import gnorm_rtol

    outs = [k for k in want if not k.startswith("start")]
    rep = {"bits_differ": sum(not np.array_equal(got[k], want[k]) for k in outs),
           "leaves": len(outs)}
    loss_keys = ["[1]", "[2]", "[3]"]
    rep["loss"] = max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-30)
                      for k in loss_keys)
    gnorms = [k for k in outs if k.startswith("[4]")]
    rep["gnorm_rtol"] = gnorm_rtol({k: float(got[k]) for k in gnorms},
                                   {k: float(want[k]) for k in gnorms})
    stats = 0.0
    for k in outs:
        if "'batch_stats'" in k:
            w = want[k].astype(np.float64)
            err = np.maximum(np.abs(got[k].astype(np.float64) - w) - 1e-7, 0)
            stats = max(stats, float((err / np.maximum(np.abs(w), 1e-30)).max()))
    rep["stats_rtol"] = stats
    for net in NETS:
        p = f"[0]['{net}']['params']"
        mu = f"[0]['opt_{net}']"
        g_w = _of({k: v for k, v in want.items() if ".mu" in k}, mu) / 0.1
        g_g = _of({k: v for k, v in got.items() if ".mu" in k}, mu) / 0.1
        if not g_w.any():
            continue
        d_w, d_g = (_of(r, p) - r[f"start {net}"] for r in (want, got))
        flips = np.sign(g_g) != np.sign(g_w)
        steady = (np.abs(g_w) >= 1e-6) & ~flips
        rep[f"{net}_updates"] = _rel_l2(d_g[steady], d_w[steady])
        rep[f"{net}_flips"] = float(np.linalg.norm(g_w[flips]) / np.linalg.norm(g_w))
        rep[f"{net}_mu"] = _rel_l2(g_g[steady], g_w[steady])
    return rep


def cache(configs) -> None:
    """``cache``'s table."""
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        for config in configs:
            cache_dir = f"{tmp}/cache-{config}"
            os.makedirs(cache_dir)
            runs = [("fresh", ["--cache", "off"], {}),
                    ("fresh again", ["--cache", "off"], {}),
                    ("cold cache", ["--cache", cache_dir], {}),
                    ("warm cache", ["--cache", cache_dir], {}),
                    ("compiled for AVX2", ["--cache", "off"],
                     {"XLA_FLAGS": "--xla_cpu_max_isa=AVX2"}),
                    ("input x 1+1e-7 N, seed 1", ["--cache", "off", "--seed", "1"], {}),
                    ("input x 1+1e-7 N, seed 2", ["--cache", "off", "--seed", "2"], {})]
            outs = []
            for label, args, env in runs:
                out = f"{tmp}/{config}-{len(outs)}.npz"
                start = time.perf_counter()
                subprocess.run([sys.executable, me, "run", config, out, *args], check=True,
                               env={**os.environ, **env})
                print(f"  ({label}: {time.perf_counter() - start:.1f} s in all)", flush=True)
                outs.append((label, _load(out)))
            ref = outs[0][1]
            for label, got in outs[1:]:
                rep = distances(got, ref)
                print(f"{config} {label} vs fresh: " + ", ".join(
                    f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in rep.items()), flush=True)


def port_step(pair: dict, threads: int, assets: str) -> dict:
    """The test's ``distances`` of the port's step from the JAX initial
    state with torch on ``threads`` threads."""
    import torch

    import test_torch_train_step as t
    from prior_diffuse_tpu_torch import config as tcfg
    from prior_diffuse_tpu_torch.convert import flax_to_state_dict
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        run = tcfg.RunConfig(assets=assets, doc="t", data_root=pair["jtr"].run.data_root,
                             **pair["flags"])
        tr = ComplexDDPMTrainer(run, t._exp(tcfg, t.CONFIGS[pair["name"]][1]), device="cpu")
        for name in NETS:
            tr.nets[name].load_state_dict(flax_to_state_dict(tr.nets[name],
                                                             pair["state0"][name]))
        b = pair["batch"]
        *_, gnorms = tr._train_step(torch.from_numpy(b.noisy), torch.from_numpy(b.clean),
                                    torch.from_numpy(b.frame_nums).long(), draws=pair["draws"])
    finally:
        torch.set_num_threads(before)
    return t.distances(pair, tr, gnorms)


def bounds(configs) -> None:
    """``bounds``' table."""
    _env()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/jax_test_cache")
    from prior_diffuse_tpu.data import synthetic
    import test_torch_train_step as t

    fmt = lambda d: ", ".join(f"{k} {v:.3e}" for k, v in d.items())  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        corpus = synthetic.write_corpus(f"{tmp}/corpus", n_train=2, n_test=2, min_len=6000,
                                        max_len=9000, seed=5)
        for config in configs or t.SPREAD:
            start = time.perf_counter()
            pair = t.make_step_pair(config, corpus, f"{tmp}/{config}")
            print(f"{config}: fixture {time.perf_counter() - start:.1f} s; JAX's spread "
                  f"samples {pair['spread']}; bounds {fmt(pair['bounds'])}", flush=True)
            print(f"{config} port: " + fmt(t.distances(pair, pair["tr"], pair["got"][3])),
                  flush=True)
            for threads in (1, 4, 8):  # the test's worker runs torch on 2
                print(f"{config} port on {threads} torch threads: "
                      + fmt(port_step(pair, threads, f"{tmp}/{config}-{threads}")), flush=True)
            for control in t.CONTROLS:
                start = time.perf_counter()
                dist = t.wrong_port(pair, control, f"{tmp}/{config}-{control}")
                print(f"{config} {control} ({time.perf_counter() - start:.1f} s): "
                      + fmt(dist), flush=True)


def main(argv=None) -> None:
    args = list(argv if argv is not None else sys.argv[1:])
    mode = args.pop(0) if args else "cache"
    if mode == "run":
        config, out = args[:2]
        opts = dict(zip(args[2::2], args[3::2]))
        seed = opts.get("--seed")
        run(config, out, opts.get("--cache", "off"), None if seed is None else int(seed))
    elif mode == "cache":
        cache(args or ["joint_sigma_eps", "frozen_x0_leak"])
    elif mode == "bounds":
        bounds(args)
    else:
        raise SystemExit(f"unknown mode {mode!r}: cache, run or bounds")


if __name__ == "__main__":
    main()
