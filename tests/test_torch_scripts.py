"""The research drivers (``prior_diffuse_tpu_torch/scripts``) against the
repository's ``scripts/`` (CPU).

The JAX scripts' probes are closures inside their ``main()``, so the
references here recompute them from the JAX package's functions
(``ComplexDDPMTrainer._dis_apply`` / ``_ddpm_apply``, ``reverse_sample``,
``com_mse_loss``, ``torch_adam``) as the scripts do, on the weights of the
port's tiny demo run (``convert.py``), one cv or train batch, and the JAX
draws recomputed from their keys.  Both run op by op (no jit): at these
sizes a compile costs more than the run.

* ``diagnose_ddpm.probe`` against JAX's probe in both BatchNorm modes,
  every field within 2.5e-4 relative (the serving bar of
  ``test_torch_enhance.py``; the prior and the running-statistics DDPM
  are the port's packed forwards, JAX's the flax modules); the trainer's
  parameters and buffers unchanged bit for bit;
* one ``probe_predictability`` regressor step against JAX's in both
  variants, at ``test_torch_train_step.py``'s bounds for Adam's first
  step: loss 1e-5 relative, the gradient (JAX's from its first moment)
  1e-3 relative L2 over the steady elements, the elements of opposite sign
  at most 1e-3 of its norm, updates within ``2 lr`` and 1e-3 relative L2
  over the same-sign steady elements, its bound for the steps that are
  chaotic in their input's float32 rounding: the port's ``x_init`` sits
  5.6e-7 from JAX's (the packed prior against flax), and that alone moves
  JAX's own update 5.1e-5 (3,198 sign flips; cond, tiny demo weights), the
  port's 1.0e-4.  Elementwise the gradient is held
  to the same step in float64: the port no farther from it than JAX is,
  plus 1e-4 x the largest element.  (``preprocess/bias`` is a sum with
  cancellation, the padding's share of a conv before BatchNorm: both
  packages' float32 values sit 1-3 % from float64's, 1.8e-5 and 3.1e-5
  absolute at the cond variant's largest element 0.19, so the plain
  elementwise 1e-4 x largest would measure rounding, not the port);
* ``train_demo`` stage A then stage B on a tiny corpus (2 + 2 steps of 2 x
  4800): stage A moves both nets, stage B the DDPM alone (the prior's
  parameters bit for bit), stage B resumes at stage A's step, the warm
  start copies parameters and BatchNorm statistics, the report in the JAX
  script's layout (``scripts/train_demo.py:292-335``: the table's last
  column is ``delta (chain - prior)``, where the older
  ``docs/demo_speechlike.md`` had ``delta (chain - floor)``);
* ``eval_schedules --reps 0 --device cpu`` on that checkpoint: seven rows of
  0, 2, 3, 4, 6, 8 and 50 steps, each variant's enhancer on the JAX
  package's ``inference_schedule`` of the variant, ``VARIANTS`` equal to
  the JAX script's;
* ``cal_params`` against the published counts (``tests/test_models.py``)
  and, for DiffWave, JAX's own count;
* every flag of each JAX driver in the port's parser with JAX's default,
  except the ones not ported by design;
* every script run from an empty working directory with its outputs
  under a temporary ``--assets`` (or named paths): no file appears
  elsewhere and nothing under ``docs/`` changes; without a card the
  drivers raise unless ``--device cpu`` is given.
"""

import ast
import contextlib
import importlib.util
import json
import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu_torch.data.synthetic import write_corpus_speechlike
from prior_diffuse_tpu_torch.scripts import (_setup, analyze_residual, cal_metrics, cal_params,
                                             diagnose_ddpm, draw, eval_schedules,
                                             gaussian_distribution, probe_predictability,
                                             show_wav_len, train_demo)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK, BATCH = 4800, 2
STEPS_A, STEPS_B = 2, 2
CPU = ["--device", "cpu"]

# two torch threads a worker process: see test_torch_trainer.py
torch.set_num_threads(min(2, torch.get_num_threads()))


@contextlib.contextmanager
def _cwd(path):
    here = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(here)


def _params(net):
    return [p.detach().clone() for p in net.parameters()]


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """``train_demo.main`` (stage A, then stage B) on a tiny corpus, from an
    empty working directory; the stages' entry steps and which nets each
    moved are recorded."""
    root = tmp_path_factory.mktemp("drivers")
    assets, cwd = root / "assets", root / "cwd"
    cwd.mkdir()
    write_corpus_speechlike(str(assets / "data"), n_train=4, n_test=2, min_len=4800,
                            max_len=8000, seed=7)
    stages = []
    orig = train_demo.run_stage

    def stage(tr, until, args, t0):
        before = {n: _params(m) for n, m in tr.nets.items()}
        entry = tr.step
        out = orig(tr, until, args, t0)
        moved = {n: any(not torch.equal(a, b) for a, b in zip(before[n], m.parameters()))
                 for n, m in tr.nets.items()}
        stages.append({"joint": tr.run.joint, "entry": entry, "exit": tr.step,
                       "moved": moved, "epoch": tr.epoch})
        return out

    start = time.time()
    train_demo.run_stage = stage
    try:
        with _cwd(cwd):
            rec = train_demo.main(["--steps", str(STEPS_A), "--ddpm-steps", str(STEPS_B),
                                   "--batch", str(BATCH), "--chunk", str(CHUNK), "--sigma",
                                   "--log-every", "1", "--n-train", "4", "--n-test", "2",
                                   "--assets", str(assets)] + CPU)
    finally:
        train_demo.run_stage = orig
    return dict(root=root, assets=assets, cwd=cwd, rec=rec, stages=stages, start=start)


@pytest.fixture(scope="module")
def trained(demo):
    """The demo's stage-B trainer, restored from its checkpoint."""
    exp = _setup.experiment(BATCH, CHUNK)
    return _setup.trainer(str(demo["assets"]), "demo", exp, "cpu", joint=True, sigma=True)


@pytest.fixture(scope="module")
def jax_trainer(demo, trained):
    """The JAX trainer on the same corpus and config, holding the port's
    trained weights (one device: a batch of 2 is not padded)."""
    import prior_diffuse_tpu.config as jcfg
    from prior_diffuse_tpu.parallel.mesh import make_mesh
    from prior_diffuse_tpu.training import ComplexDDPMTrainer as JTrainer
    from prior_diffuse_tpu_torch.convert import state_dict_to_flax

    run = jcfg.RunConfig(assets=str(demo["root"] / "jax"), doc="demo",
                         data_root=str(demo["assets"] / "data"), joint=True, sigma=True)
    exp = jcfg.ExperimentConfig(
        train=jcfg.TrainConfig(batch_size=BATCH, n_epochs=1, chunk_length=CHUNK),
        optim=jcfg.OptimConfig(lr=5e-4), optim_ddpm=jcfg.OptimConfig(lr=2e-4))
    jtr = JTrainer(run, exp, mesh=make_mesh(dp=1))
    for name in ("dis", "ddpm"):
        net = trained.nets[name]
        tree = state_dict_to_flax(net, net.state_dict())
        jtr.state[name] = {k: jax.tree.map(jnp.asarray, v) for k, v in tree.items()}
    return jtr


def _cv_batch(tr):
    return next(iter(tr.cv_loader))


# ---- (a) diagnose_ddpm ----------------------------------------------------------

def _jax_probe(jtr, noisy, clean, frames, rng, bn_batch_stats):
    """The JAX script's ``probe`` (``scripts/diagnose_ddpm.py:87-128``)."""
    from prior_diffuse_tpu.diffusion import inference_schedule, reverse_sample
    from prior_diffuse_tpu.losses import com_mse_loss
    from prior_diffuse_tpu.training.base import spec_features

    sched = inference_schedule(jtr.exp.diffusion)
    ab_inf, T_inf = np.asarray(sched.alpha_cum), np.asarray(sched.T)
    state = jtr.state

    def masked_stats(a, b, frames):
        t = jnp.arange(a.shape[1])[None, :]
        m = (t < frames[:, None]).astype(jnp.float32)[:, :, None, None]
        ea = jnp.sum((a * m) ** 2) / jnp.sum(m * jnp.ones_like(a))
        eb = jnp.sum((b * m) ** 2) / jnp.sum(m * jnp.ones_like(b))
        cos = jnp.sum(a * b * m) / jnp.sqrt(jnp.sum((a * m) ** 2) * jnp.sum((b * m) ** 2))
        return ea, eb, cos

    feat = spec_features(noisy, jtr.cfg)
    label = spec_features(clean, jtr.cfg)
    x_init, _ = jtr._dis_apply(state["dis"], feat, train=False)
    x_init = x_init / jtr.c
    lbl = label / jtr.c
    r_true = lbl - x_init
    cond = x_init

    def model_fn(x, t):
        return jtr._ddpm_apply(state["ddpm"], x, cond, t, train=bn_batch_stats)[0]

    chain = reverse_sample(model_fn, rng, x_init, x_init.shape, sched, jtr.mode, None)
    r_samp = chain - x_init
    prior_mse = com_mse_loss(x_init * jtr.c, label, frames)
    chain_mse = com_mse_loss(chain * jtr.c, label, frames)
    e_samp, e_true, cos = masked_stats(r_samp, r_true, frames)
    per_step = []
    ks = jax.random.split(jax.random.fold_in(rng, 7), len(ab_inf))
    for n in range(len(ab_inf)):
        ab = ab_inf[n]
        eps = jax.random.normal(ks[n], r_true.shape)
        x_t = np.sqrt(ab) * r_true + np.sqrt(1.0 - ab) * eps
        t_vec = jnp.full((r_true.shape[0],), T_inf[n])
        eps_hat, _ = jtr._ddpm_apply(state["ddpm"], x_t, cond, t_vec, train=bn_batch_stats)
        per_step.append((com_mse_loss(eps_hat, eps, frames),
                         com_mse_loss(x_t / np.sqrt(1.0 - ab), eps, frames)))
    return (prior_mse, chain_mse, e_true, e_samp, cos), per_step


def _jax_probe_draws(rng, shape, n_steps):
    """``x_T [1, *shape]`` and the per-step eps ``[N, *shape]`` the JAX probe
    draws from ``rng``."""
    init_rng, _ = jax.random.split(rng)
    x_T = jax.random.normal(init_rng, shape, jnp.float32)
    ks = jax.random.split(jax.random.fold_in(rng, 7), n_steps)
    eps = jnp.stack([jax.random.normal(k, shape) for k in ks])
    return torch.from_numpy(np.array(x_T))[None], torch.from_numpy(np.array(eps))


@pytest.mark.parametrize("bn_batch", [False, True], ids=["running", "batch"])
def test_diagnose_probe_matches_jax(trained, jax_trainer, bn_batch):
    batch = _cv_batch(trained)
    noisy, clean, frames = trained.put_batch(batch.noisy, batch.clean, batch.frame_nums)
    jn, jc, jf = jax_trainer.put_batch(batch.noisy, batch.clean, batch.frame_nums)
    rng = jax.random.PRNGKey(123)
    want = diagnose_ddpm.record(bn_batch, 0, trained.enhancer.sched,
                                _jax_probe(jax_trainer, jn, jc, jf, rng, bn_batch))
    shape = (len(batch.frame_nums), batch.noisy.shape[1] // 160 + 1, 161, 2)
    x_T, eps = _jax_probe_draws(rng, shape, trained.enhancer.sched.num_steps)
    snap = {n: {k: v.clone() for k, v in m.state_dict().items()}
            for n, m in trained.nets.items()}
    got = diagnose_ddpm.record(bn_batch, 0, trained.enhancer.sched,
                               diagnose_ddpm.probe(trained, noisy, clean, frames, bn_batch,
                                                   x_T=x_T, eps=eps))
    for n, m in trained.nets.items():  # the probe leaves the trainer as it was
        for k, v in m.state_dict().items():
            assert torch.equal(v, snap[n][k]), (n, k)
    assert [set(s) for s in got["eps_mse_per_step"]] == [set(s) for s in
                                                         want["eps_mse_per_step"]]
    assert set(got) == set(want) and got["bn"] == want["bn"]
    for k in ("prior_mse", "chain_mse", "res_energy_true", "res_energy_sampled", "res_cos"):
        np.testing.assert_allclose(got[k], want[k], rtol=2.5e-4, err_msg=k)
    for g, w in zip(got["eps_mse_per_step"], want["eps_mse_per_step"]):
        np.testing.assert_allclose([g[k] for k in ("T", "alpha_cum", "model", "trivial")],
                                   [w[k] for k in ("T", "alpha_cum", "model", "trivial")],
                                   rtol=2.5e-4, err_msg=str(g["n"]))


# ---- (b) probe_predictability ---------------------------------------------------

def _train_batch(tr):
    from prior_diffuse_tpu_torch.data.dataset import _collate

    ds = tr.tr_dataset
    rng = np.random.default_rng(0)
    return _collate([ds.load_pair(j, crop=True, rng=rng) for j in range(BATCH)], CHUNK)


def _flat(tree):
    return np.concatenate([np.asarray(a).ravel() for a in jax.tree.leaves(tree)])


@pytest.mark.parametrize("variant", ["cond", "cond+noisy"])
def test_regressor_step_matches_jax(trained, jax_trainer, variant):
    """One ``train_step`` of the JAX script (``probe_predictability.py:
    129-148``, recomputed) against the port's, from JAX's initialisation."""
    import optax

    from prior_diffuse_tpu.training.base import spec_features as jspec
    from prior_diffuse_tpu.training.optim import torch_adam as jadam
    from prior_diffuse_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
    from prior_diffuse_tpu_torch.training.optim import torch_adam

    jtr, lr, use_noisy = jax_trainer, 2e-4, variant == "cond+noisy"
    reg = jtr.ddpm_model
    t_fix = float(np.asarray(jtr.num_steps - 1, np.float32))
    dummy = jnp.zeros((1, 31, 161, 2))
    reg_vars = reg.init(jax.random.PRNGKey(77), dummy, dummy, jnp.zeros((1,)), train=False)
    tx = jadam(lr)
    opt_state = tx.init(reg_vars["params"])
    batch = _train_batch(trained)
    noisy, clean, frames = jtr.put_batch(batch.noisy, batch.clean, batch.frame_nums)
    feat, label = jspec(noisy, jtr.cfg), jspec(clean, jtr.cfg)
    x_init = jtr._dis_apply(jtr.state["dis"], feat, train=False)[0] / jtr.c
    r_true = label / jtr.c - x_init
    x_in = feat / jtr.c if use_noisy else jnp.zeros_like(x_init)
    tvec = jnp.full((noisy.shape[0],), t_fix)
    m = (jnp.arange(x_init.shape[1])[None, :] < frames[:, None]).astype(jnp.float32)
    m = m[:, :, None, None]

    def loss_fn(params):
        pred = reg.apply({"params": params, "batch_stats": reg_vars["batch_stats"]}, x_in,
                         x_init, tvec, train=True, mutable=["batch_stats"])[0]
        return jnp.sum(((pred - r_true) * m) ** 2) / jnp.sum(m * jnp.ones_like(pred))

    loss, grads = jax.value_and_grad(loss_fn)(reg_vars["params"])
    updates, new_opt = tx.update(grads, opt_state, reg_vars["params"])
    new_params = optax.apply_updates(reg_vars["params"], updates)

    net = probe_predictability.regressor(trained, 0)
    net.load_state_dict(flax_to_state_dict(net, jax.tree.map(np.asarray, reg_vars)))
    old = _flat(state_dict_to_flax(net, net.state_dict())["params"])
    opt = torch_adam(net.parameters(), lr)
    got_loss = probe_predictability.train_step(
        trained, net, opt, *trained.put_batch(batch.noisy, batch.clean, batch.frame_nums),
        use_noisy)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)

    g_want = _flat(grads)
    grad_tree = lambda m: state_dict_to_flax(m, {n: p.grad for n, p in m.named_parameters()})
    g_got = _flat(grad_tree(net)["params"])
    mu_want = _flat(next(s for s in new_opt.inner_state
                         if isinstance(s, optax.ScaleByAdamState)).mu)
    np.testing.assert_allclose(mu_want, 0.1 * g_want, rtol=1e-6, atol=1e-12)
    # the same step's gradient in float64, on the port's inputs
    net64 = probe_predictability.regressor(trained, 0).double()
    net64.load_state_dict({k: v.double() if v.is_floating_point() else v for k, v in
                           flax_to_state_dict(net64, jax.tree.map(np.asarray, reg_vars)).items()})
    x_in64, x_init64, r_true64 = (t.double() for t in probe_predictability.fields(
        trained, *trained.put_batch(batch.noisy, batch.clean)[:2], use_noisy))
    net64.train()
    pred = net64(x_in64, x_init64, torch.full((BATCH,), t_fix, dtype=torch.float64))
    probe_predictability.masked_mse_cos(pred, r_true64, torch.from_numpy(
        batch.frame_nums))[0].backward()
    g64 = _flat(grad_tree(net64)["params"])
    assert (np.abs(g_got - g64) <= np.abs(g_want - g64) + 1e-4 * np.abs(g_want).max()).all()
    flips = np.sign(g_got) != np.sign(g_want)
    assert np.linalg.norm(g_want[flips]) <= 1e-3 * np.linalg.norm(g_want)
    steady = (np.abs(g_want) >= 1e-6) & ~flips
    assert steady.mean() > 0.5
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(g_got[steady], g_want[steady]) <= 1e-3
    d_want = _flat(new_params) - old
    d_got = _flat(state_dict_to_flax(net, net.state_dict())["params"]) - old
    assert np.abs(d_got - d_want).max() <= 2 * lr
    assert rel(d_got[steady], d_want[steady]) <= 1e-3


# ---- (c) train_demo ----------------------------------------------------------------

def test_stages_freeze_the_prior_and_resume(demo):
    a, b = demo["stages"]
    assert (a["joint"], a["entry"], a["exit"]) == (True, 0, STEPS_A)
    assert a["moved"] == {"dis": True, "ddpm": True}
    # stage B resumes from stage A's checkpoint: its step and the next epoch
    assert (b["joint"], b["entry"], b["exit"]) == (False, STEPS_A, STEPS_A + STEPS_B)
    assert b["moved"] == {"dis": False, "ddpm": True}
    assert (a["epoch"], b["epoch"]) == (1, 2)
    assert demo["rec"]["step"] == STEPS_A + STEPS_B


def test_stage_b_keeps_the_prior_parameters(demo, trained):
    """The prior's parameters after stage B equal stage A's checkpoint bit
    for bit; its BatchNorm statistics moved (it ran in train mode, as in
    JAX's non-joint step), and so did the DDPM."""
    from prior_diffuse_tpu_torch.training.checkpoint import CheckpointStore

    ckpt = demo["assets"] / "checkpoint" / "demo"
    stage_a = CheckpointStore(str(ckpt))._load(str(ckpt / "epochs" / "0.pt"))["state"]
    dis = trained.nets["dis"].state_dict()
    params = {n for n, _ in trained.nets["dis"].named_parameters()}
    for k, v in stage_a["dis"].items():
        if k in params:
            assert torch.equal(dis[k], v), k
    assert any(not torch.equal(dis[k], v) for k, v in stage_a["dis"].items()
               if k.endswith("running_mean"))
    ddpm = trained.nets["ddpm"].state_dict()
    assert any(not torch.equal(ddpm[k], v) for k, v in stage_a["ddpm"].items())


def test_train_records_have_jax_keys(demo):
    from prior_diffuse_tpu_torch.scripts import _report

    with open(demo["assets"] / "log" / "demo" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "loss_sum" in r]
    assert [r["step"] for r in steps] == list(range(1, STEPS_A + STEPS_B + 1))
    for r in steps:
        assert {"loss_sum", "dis_loss", "ddpm_loss"} <= set(r)
        assert any(k.startswith("gn_dis/") for k in r) and any(k.startswith("gn_ddpm/")
                                                             for k in r)
        assert all(np.isfinite(v) for k, v in r.items() if k != "time")
    assert [r["dis_loss"] for r in steps[STEPS_A:]] == [0.0] * STEPS_B
    assert [r["step"] for r in recs if "test_prior_mse" in r] == [STEPS_A + STEPS_B]
    rec = demo["rec"]
    assert list(rec) == ["step", "pesq_mode", "floor", "prior_only", "enhanced"]
    for part in ("floor", "prior_only", "enhanced"):
        assert list(rec[part]) == list(_report.NAMES)
        assert all(np.isfinite(v) for v in rec[part].values())


def test_report_layout(demo):
    with open(demo["assets"] / "demo_speechlike.md") as f:
        lines = f.read().splitlines()
    assert lines[0] == "# Speech-like convergence demo"
    assert lines[2] == ("Corpus: 4 train / 2 test speech-like utterances (`make_speechlike`), "
                        "SNR 0 to 15 dB.")
    assert lines[3] == (f"Model: DiffUNet prior + DiffUNet1 residual DDPM, batch {BATCH}, "
                        f"{STEPS_A} joint steps + {STEPS_B} DDPM-only steps, "
                        "sigma-conditioned, lam 1.")
    assert lines[5].startswith(f"**PESQ regime: `{demo['rec']['pesq_mode']}`**")
    table = lines[lines.index("| metric | noisy floor | prior only | full chain | "
                              "delta (chain - prior) |"):]
    assert table[1] == "|---|---|---|---|---|"
    cell = r"-?\d+\.\d{3}( \(floor\))?"
    row = re.compile(rf"\| (\w+) \| {cell} \| {cell} \| {cell} \| ([+-]\d+\.\d{{3}}|n/a "
                     r"\(floor\)) \|")
    assert [row.fullmatch(line).group(1) for line in table[2:8]] == [
        "CSIG", "CBAK", "COVL", "PESQ", "SSNR", "STOI"]
    for line, name in zip(table[2:8], ["CSIG", "CBAK", "COVL", "PESQ", "SSNR", "STOI"]):
        floor, prior, chain = (float(c.split()[0]) for c in line.split("|")[2:5])
        assert [round(v, 3) for v in (floor, prior, chain)] == [
            demo["rec"][k][name] for k in ("floor", "prior_only", "enhanced")]


def test_warm_start_copies_the_prior(demo, tmp_path):
    """``--warm-start-dis``: a fresh trainer's prior takes the source run's
    best parameters and BatchNorm statistics; the DDPM stays as drawn."""
    from prior_diffuse_tpu_torch.training.checkpoint import CheckpointStore

    args = train_demo.parse_args(["--assets", str(tmp_path), "--warm-start-dis",
                                  str(demo["assets"])] + CPU)
    exp = _setup.experiment(BATCH, CHUNK)
    tr = _setup.trainer(str(tmp_path), "demo", exp, "cpu", joint=True, sigma=True,
                        data_root=str(demo["assets"] / "data"))
    ddpm0 = {k: v.clone() for k, v in tr.ddpm.state_dict().items()}
    train_demo.maybe_warm_start(tr, args)
    best = CheckpointStore(str(demo["assets"] / "checkpoint" / "demo")).restore_best()
    got = tr.dis.state_dict()
    assert set(got) == set(best["state"]["dis"])
    for k, v in best["state"]["dis"].items():
        assert torch.equal(got[k], v), k
    assert all(torch.equal(v, ddpm0[k]) for k, v in tr.ddpm.state_dict().items())
    with pytest.raises(SystemExit, match="no checkpoint"):
        train_demo.maybe_warm_start(tr, train_demo.parse_args(
            ["--assets", str(tmp_path), "--warm-start-dis", str(tmp_path / "none")] + CPU))


# ---- (d) eval_schedules -------------------------------------------------------------

def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sweep(demo):
    from prior_diffuse_tpu_torch.serving import enhance

    servers = []
    orig = enhance.enhance_files

    def record(server, *args, **kwargs):
        servers.append(server)
        return orig(server, *args, **kwargs)

    enhance.enhance_files = record
    try:
        with _cwd(demo["cwd"]):
            rows = eval_schedules.main(["--assets", str(demo["assets"]), "--doc", "demo",
                                        "--sigma", "--reps", "0", "--batch", "2"] + CPU)
    finally:
        enhance.enhance_files = orig
    return rows, servers


def test_sweep_rows_and_schedules(demo, sweep):
    import prior_diffuse_tpu.config as jcfg
    from prior_diffuse_tpu.diffusion import inference_schedule as jsched

    rows, servers = sweep
    assert eval_schedules.VARIANTS == _jax_script("eval_schedules").VARIANTS
    assert [r["variant"] for r in rows] == [v for v, _ in eval_schedules.VARIANTS]
    assert [r["steps"] for r in rows] == [0, 2, 3, 4, 6, 8, 50]
    assert [r["served"] for r in rows] == ["prior_only:float32"] + ["float32:fused"] * 6
    for r in rows:
        assert all(np.isfinite(r[k]) for k in ("csig", "cbak", "covl", "pesq", "ssnr", "stoi"))
        assert np.isnan(r["ms_per_batch"])  # --reps 0: no timing
    assert not hasattr(servers[0], "sched")  # the prior-only server
    for (name, sched), server in zip(eval_schedules.VARIANTS[1:], servers[1:]):
        base = jcfg.DiffusionConfig()
        want = jsched(base if sched == "default" else
                      jcfg.DiffusionConfig(fast_sampling=False) if sched == "full" else
                      jcfg.DiffusionConfig(inference_noise_schedule=sched))
        for k in ("alpha_cum", "T", "c1", "c2"):
            np.testing.assert_allclose(getattr(server.sched, k), np.asarray(getattr(want, k)),
                                       rtol=1e-12, err_msg=f"{name} {k}")
    with open(demo["assets"] / "schedule_tradeoff_f32.json") as f:
        assert json.load(f)["rows"] == json.loads(json.dumps(rows))


# ---- (e) cal_params -----------------------------------------------------------------

PUBLISHED = {"GCRN": 9_771_340, "GRN": 3_131_731, "aia_complex_trans_ri": 1_179_030,
             "dual_aia_trans_merge_crm": 2_810_859, "dual_aia_complex_trans": 2_085_935,
             "aia_complex_trans_mag": 906_905, "DiffUNet": 1_662_565,
             "DiffUNet1": 2_780_273, "Nocon": 2_780_263}


def test_cal_params_counts(capsys):
    from prior_diffuse_tpu.models.diffwave import DiffWave as JDiffWave

    got = cal_params.main()
    out = capsys.readouterr().out.splitlines()
    assert list(got) == sorted([*PUBLISHED, "DiffWave"])  # the JAX registry's order
    assert {k: v for k, v in got.items() if k != "DiffWave"} == PUBLISHED
    jvars = JDiffWave().init(jax.random.PRNGKey(0), jnp.zeros((1, 800)), jnp.zeros((1, 800)),
                             jnp.zeros((1,)))
    assert got["DiffWave"] == sum(int(np.prod(p.shape)) for p in jax.tree.leaves(
        jvars["params"]))
    assert out == [f"{name:28s} {n:>12,d} params" for name, n in got.items()]


# ---- the JAX drivers' flags ---------------------------------------------------------

NOT_PORTED = {"--cpu", "--max-rss-gb"}


def _jax_flags(name):
    """``{flag: default}`` of a JAX script's ``add_argument`` calls."""
    tree = ast.parse(open(os.path.join(ROOT, "scripts", f"{name}.py")).read())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                and node.args and isinstance(node.args[0], ast.Constant)):
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("default", "action")}
            out[node.args[0].value] = kw.get("default", False if kw.get("action") ==
                                             "store_true" else None)
    return out


@pytest.mark.parametrize("module", [train_demo, eval_schedules, diagnose_ddpm,
                                    probe_predictability],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_jax_flags_ported_with_their_defaults(module):
    name = module.__name__.rsplit(".", 1)[-1]
    want = _jax_flags(name)
    assert want
    required = ["--assets", "x", "--doc", "x"] if name == "eval_schedules" else []
    got = vars(module.parse_args(required + CPU))
    # the JAX defaults that wrote into the repository lie under --assets
    moved = {"--report", "--out"}
    for flag, default in want.items():
        if flag in NOT_PORTED:
            continue
        key = flag.lstrip("-").replace("-", "_")
        assert key in got, flag
        if flag not in moved and not (name == "eval_schedules" and flag in ("--assets",
                                                                           "--doc")):
            assert got[key] == default, flag


# ---- (f) outputs and devices ---------------------------------------------------------

def test_every_script_writes_under_its_assets(demo, sweep, trained, tmp_path, capsys):
    """Each remaining script from the demo's empty working directory, its
    outputs under the demo's assets or named paths there."""
    assets, cwd = demo["assets"], demo["cwd"]
    data = assets / "data"
    out = assets / "small"
    with _cwd(cwd):
        recs = diagnose_ddpm.main(["--assets", str(assets), "--sigma", "--batch", "2"] + CPU)
        assert [r["bn"] for r in recs] == ["running", "batch"]
        rec = probe_predictability.main(["--assets", str(assets), "--sigma", "--steps", "1",
                                         "--eval-every", "1", "--batch", "2", "--chunk",
                                         str(CHUNK)] + CPU)
        assert rec["step"] == 1 and (assets / "probe_predictability_cond.json").is_file()
        floor = cal_metrics.main([str(data)])
        np.testing.assert_allclose(floor, [demo["rec"]["floor"][k] for k in (
            "CSIG", "CBAK", "COVL", "PESQ", "SSNR", "STOI")], atol=5e-4)
        rms = analyze_residual.main([str(data / "clean_testset_wav"), str(assets / "enhanced"),
                                     str(out / "residual"), "2"])
        assert len(rms) == 2 and (out / "residual" / "residual_ste_000.wav.png").is_file()
        name = "ste_000.wav"
        draw.main([name, str(data / "noisy_testset_wav"), str(data / "clean_testset_wav"), "-",
                   str(assets / "enhanced"), str(out / "draw.png")] + CPU)
        assert (out / "draw.png").is_file()
        ks = gaussian_distribution.main([str(data / "clean_testset_wav"), "2"] + CPU)
        assert len(ks) == 2 and all(0 <= p <= 1 for pair in ks.values() for p in pair)
        lengths = show_wav_len.main([str(data / "noisy_trainset_wav"), str(out / "len.png")])
        assert len(lengths) == 4 and (out / "len.png").is_file()
    capsys.readouterr()
    assert os.listdir(cwd) == []
    for dirpath, _, filenames in os.walk(os.path.join(ROOT, "docs")):
        for f in filenames:
            assert os.path.getmtime(os.path.join(dirpath, f)) < demo["start"], f


def test_drivers_refuse_without_a_card(tmp_path):
    """The default device is the card; without one each driver raises
    before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with _cwd(tmp_path):
        for module, argv in ((train_demo, []), (eval_schedules, ["--doc", "demo"]),
                             (diagnose_ddpm, []), (probe_predictability, [])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                module.main(["--assets", str(tmp_path / "a")] + argv)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gaussian_distribution.main([str(tmp_path)])
    assert os.listdir(tmp_path) == []


def test_every_script_has_a_counterpart_or_a_reason():
    """Each module of the repository's ``scripts/`` has a counterpart of the
    same name under ``prior_diffuse_tpu_torch/scripts``, or ROADMAP.md's
    "Not ported, by design" bullet names it."""
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        roadmap = f.read()
    bullet = roadmap[roadmap.index("**Not ported, by design**"):]
    bullet = bullet[:bullet.index("\n\n")]
    port = os.path.join(ROOT, "prior_diffuse_tpu_torch", "scripts")
    missing = []
    for name in sorted(os.listdir(os.path.join(ROOT, "scripts"))):
        stem, ext = os.path.splitext(name)
        if ext == ".py" and not os.path.isfile(os.path.join(port, name)) and (
                f"`scripts/{name}`" not in bullet and f"`{name}`" not in bullet):
            missing.append(name)
        if ext == ".sh" and not re.search(rf"`scripts/{re.escape(stem[:2])}[^`]*`|`{name}`",
                                          bullet):
            missing.append(name)
    assert not missing, missing
