"""One bf16 train step of the port's ComplexDDPMTrainer against the JAX
trainer's (CPU), and what follows it.

Both trainers train with ``train.compute_dtype: bfloat16`` (the default
system: a ``DiffUNet`` prior, the ``DiffUNet1`` denoiser, pirorgrad,
``--joint --sigma``): f32 parameters and Adam state, the STFT and the
losses in f32, both nets through the dual train forward
(``models/fused_forward.py::dual_train_forward``, JAX's default in bf16).
The JAX trainer runs on a 1-device mesh (``test_torch_train_step.py``
says why), batch 2 x 1600 samples (11 frames); its initial state is
carried into the port by ``convert.py``, and the port gets the numbers the
JAX q-sample drew.  One module-scoped fixture compiles the JAX step (a few
minutes on the CPU), which the checkpoint test calls again.

bf16 rounds at 2^-9, and train-mode BatchNorm over 22 rows amplifies a
flipped rounding, so a bf16 step is held to the spread of the reference
itself: JAX's jitted step against the same step op by op
(``jax.disable_jit``) and against the jitted step on the batch times ``1 +
1e-7 N(0, 1)`` (two seeds), ``python3 tools/bf16_train_probe.py step``
(on the CPU; ROADMAP Queue 3).  For ``ddpm-DiffUNet`` JAX's three runs sit
from the jitted one by up to: losses 7.1e-5; a group gradient norm 169 %
(``preprocess``, a 1x1 conv whose gradient sums bf16 terms over the whole
spectrogram), 1.3e-2 of the net's largest norm; BN statistics 1.1e-3
relative L2 (all of a net's); the gradient 0.104 relative L2, 2.4e-2 of
its norm in elements whose sign flips; Adam's updates 1.2e-2 over the
same-sign elements.  The port sits from the jitted step within that
(losses 1.1e-5, group norms 54 % / 6.6e-3, statistics 1.2e-3, gradient
9.5e-2, flips 2.2e-2, updates 1.3e-2): a second sample of the same
rounding noise.  So each bound (``BOUNDS``, every case of the probe) is
twice the largest of JAX's three samples, rounded up to one significant
digit, and every update within ``2 * lr`` as in the f32 tests.  A group
norm passes within its relative bound or within its share of the net's
largest group norm.  The share of the gradient's norm whose sign flips is
printed by the probe, not bounded: it follows the gradient's relative L2,
which is, and GRN's (8.6e-3) sits above twice JAX's (3.9e-3), as its
gradient sits near the bound: its convs sum in another order than XLA's,
which these samples do not vary (``test_torch_bf16_train_complex.py``;
ROADMAP Queue 3).

* the eval step after it (JAX's ``_eval_step`` on the new state: the
  bf16-compute modules with two decoders, ``x_init`` divided by ``c`` in
  bf16, the chain in f32, the same ``x_T``) within 2e-2 relative RMS;
* a JAX bf16 checkpoint (f32 parameters, as JAX's) converted by
  ``convert.py::payload_from_jax`` unchanged takes JAX's next step;
* six bf16 steps lower the prior's loss with the parameters and Adam
  state f32 (the port's ``test_mixed_precision_training_reduces_loss``).
"""

import copy
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prior_diffuse_tpu.config as jcfg
from prior_diffuse_tpu.data import synthetic
from prior_diffuse_tpu.parallel.mesh import make_mesh
from prior_diffuse_tpu_torch import config as tcfg
from prior_diffuse_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from prior_diffuse_tpu_torch.data.dataset import PairedWavDataset, _collate
from prior_diffuse_tpu_torch.serving.enhancer import ComputeEnhancer
from test_torch_train_step import _adam, _flat, _jax_draws, _np, _rel_l2

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 1600
# case: (trainer, prior, loss, learning rate of each net)
CASES = {
    "ddpm-DiffUNet": ("ComplexDDPMTrainer", "DiffUNet", "com_mse_loss", (5e-4, 2e-4)),
    "ddpm-GCRN": ("ComplexDDPMTrainer", "GCRN", "com_mse_loss", (5e-4, 2e-4)),
    "complex-GCRN": ("ComplexTrainer", "GCRN", "com_mag_mse_loss", (2e-4,)),
    "complex-aia_complex_trans_ri": ("ComplexTrainer", "aia_complex_trans_ri",
                                     "com_mag_mse_loss", (5e-4,)),
    "mag-GRN": ("MagTrainer", "GRN", "mag_mse_loss", (2e-4,)),
}
# twice JAX's own spread (module docstring): losses (relative), group norms
# (relative, or of the net's largest norm), BN statistics, gradient and
# same-sign updates (relative L2)
BOUNDS = {
    "ddpm-DiffUNet": dict(loss=2e-4, gnorm=4.0, gnorm_of_max=3e-2, stats=3e-3, grad=0.3,
                          updates=3e-2),
    "ddpm-GCRN": dict(loss=3e-4, gnorm=2.0, gnorm_of_max=2e-2, stats=3e-3, grad=0.2,
                      updates=3e-2),
    "complex-GCRN": dict(loss=8e-5, gnorm=3e-2, gnorm_of_max=4e-3, stats=5e-5, grad=5e-2,
                         updates=9e-3),
    "complex-aia_complex_trans_ri": dict(loss=2e-4, gnorm=0.7, gnorm_of_max=5e-2, stats=0.0,
                                         grad=0.2, updates=2e-2),
    "mag-GRN": dict(loss=2e-3, gnorm=0.4, gnorm_of_max=4e-3, stats=5e-3, grad=8e-2,
                    updates=2e-2),
}


def write_corpus(root: str) -> str:
    return synthetic.write_corpus_speechlike(root, n_train=4, n_test=3, min_len=2000,
                                             max_len=3000, seed=8)


def experiment(module, case: str):
    """The case's bf16 experiment config in ``module`` (either package's
    ``config``)."""
    _, prior, loss, lrs = CASES[case]
    return module.ExperimentConfig(
        train=module.TrainConfig(batch_size=2, n_epochs=1, chunk_length=CHUNK, loss=loss,
                                 compute_dtype="bfloat16"),
        model=module.ModelConfig(prior), optim=module.OptimConfig(lr=lrs[0]),
        optim_ddpm=module.OptimConfig(lr=lrs[-1]))


def nets_of(case: str):
    return ("dis", "ddpm") if CASES[case][0] == "ComplexDDPMTrainer" else ("model",)


def _flags(case: str) -> dict:
    return dict(joint=True, sigma=True) if CASES[case][0] == "ComplexDDPMTrainer" else {}


def port_trainer(case: str, assets, corpus: str):
    """The port's bf16 trainer of ``case`` on the CPU."""
    from prior_diffuse_tpu_torch.training.complex_trainer import ComplexTrainer
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer
    from prior_diffuse_tpu_torch.training.mag_trainer import MagTrainer

    cls = {"ComplexDDPMTrainer": ComplexDDPMTrainer, "ComplexTrainer": ComplexTrainer,
           "MagTrainer": MagTrainer}[CASES[case][0]]
    run = tcfg.RunConfig(assets=str(assets), doc="t", data_root=corpus, **_flags(case))
    return cls(run, experiment(tcfg, case), device="cpu")


def trainers(case: str, tmp, corpus: str):
    """(JAX trainer, port trainer) of ``case``, the port holding JAX's
    initial state."""
    import prior_diffuse_tpu.training as jtraining

    jrun = jcfg.RunConfig(assets=f"{tmp}/jax", doc="t", data_root=corpus, **_flags(case))
    jtr = getattr(jtraining, CASES[case][0])(jrun, experiment(jcfg, case),
                                             mesh=make_mesh(dp=1))
    tr = port_trainer(case, f"{tmp}/torch", corpus)
    for name in nets_of(case):
        tr.nets[name].load_state_dict(flax_to_state_dict(tr.nets[name], _np(jtr.state[name])))
    return jtr, tr


def batch_of(corpus: str):
    ds = PairedWavDataset(f"{corpus}/noisy_trainset_wav", f"{corpus}/clean_trainset_wav",
                          chunk_length=CHUNK)
    rng = np.random.default_rng(0)
    return _collate([ds.load_pair(j, crop=True, rng=rng) for j in range(2)], CHUNK)


def torch_batch(batch):
    return (torch.from_numpy(batch.noisy), torch.from_numpy(batch.clean),
            torch.from_numpy(batch.frame_nums).long())


def jax_run(case: str, state, losses, gnorms) -> dict:
    """A step's outcome from a JAX state after it: losses, group norms,
    each net's parameters, BN statistics and gradient (Adam's first moment
    over 0.1, plus ``l2 w``) flattened."""
    return {"losses": np.array([float(v) for v in losses]),
            "gnorms": {k: float(v) for k, v in gnorms.items()},
            "params": {n: _flat(_np(state[n]["params"])) for n in nets_of(case)},
            "stats": {n: jax.tree.leaves(_np(state[n]["batch_stats"])) for n in nets_of(case)},
            "grads": {n: _flat(_np(_adam(state["opt" if n == "model" else "opt_" + n]).mu))
                      / 0.1 for n in nets_of(case)}}


def port_run(case: str, tr, losses, gnorms) -> dict:
    """:func:`jax_run` of the port's trainer after its step."""
    out = {"losses": np.array([float(v) for v in losses]),
           "gnorms": {k: float(v) for k, v in gnorms.items()},
           "params": {}, "stats": {}, "grads": {}}
    for n in nets_of(case):
        net = tr.nets[n]
        tree = state_dict_to_flax(net, net.state_dict())
        out["params"][n] = _flat(tree["params"])
        out["stats"][n] = jax.tree.leaves(tree.get("batch_stats", {}))
        out["grads"][n] = _flat(state_dict_to_flax(net, {
            k: torch.zeros_like(p) if p.grad is None else p.grad
            for k, p in net.named_parameters()})["params"])
    return out


def step_pair(case: str, tmp, corpus: str = None) -> dict:
    """The JAX trainer's jitted bf16 step and the port's from one state on
    one batch; ``eager()`` runs JAX's step op by op from the same state."""
    corpus = corpus or write_corpus(f"{tmp}/corpus")
    jtr, tr = trainers(case, tmp, corpus)
    state0 = {n: _flat(_np(jtr.state[n]["params"])) for n in nets_of(case)}
    start = jax.tree.map(jnp.array, jtr.state)
    batch = batch_of(corpus)
    arrays = jtr.put_batch(batch.noisy, batch.clean, batch.frame_nums)
    ddpm = CASES[case][0] == "ComplexDDPMTrainer"
    rng = jax.random.PRNGKey(11)
    if ddpm:
        jstate, *losses, gnorms = jtr._train_step(jtr.state, *arrays, rng)
        draws = _jax_draws(rng, jtr.exp.diffusion, (2, CHUNK // 160 + 1, 161, 2))
        *got_losses, got_gnorms = tr._train_step(*torch_batch(batch), draws=draws)
    else:
        jstate, loss, gnorms = jtr._train_step(jtr.state, *arrays)
        losses = [loss]
        got_loss, got_gnorms = tr._train_step(*torch_batch(batch))
        got_losses = [got_loss]
    jtr.state = jstate
    jtr.step += 1
    tr.step += 1

    def eager():
        with jax.disable_jit():
            if ddpm:
                state, *ls, gn = jtr._train_step_impl(start, *arrays, rng, joint=True,
                                                      sigma=True)
            else:
                state, loss, gn = jtr._train_step_impl(start, *arrays)
                ls = [loss]
        return jax_run(case, state, ls, gn)

    def perturbed(seed: int):
        """JAX's jitted step on the batch times ``1 + 1e-7 N(0, 1)``."""
        g = np.random.default_rng(seed)
        wavs = [a * (1 + 1e-7 * g.standard_normal(a.shape)).astype(np.float32)
                for a in (batch.noisy, batch.clean)]
        args = (*jtr.put_batch(*wavs, batch.frame_nums), *((rng,) if ddpm else ()))
        state, *ls, gn = jtr._train_step(jax.tree.map(jnp.array, start), *args)
        return jax_run(case, state, ls, gn)

    return dict(case=case, jtr=jtr, tr=tr, batch=batch, state0=state0, start=start,
                arrays=arrays, eager=eager, perturbed=perturbed,
                want=jax_run(case, jstate, losses, gnorms),
                got=port_run(case, tr, got_losses, got_gnorms),
                after=copy.deepcopy(tr.ckpt_payload()))


def step_report(pair: dict, run: dict) -> dict:
    """How far ``run`` (a step's outcome) sits from the JAX jitted step."""
    want, lrs = pair["want"], CASES[pair["case"]][3]
    rep = {"loss": float(np.max(np.abs(run["losses"] - want["losses"])
                                / np.maximum(np.abs(want["losses"]), 1e-30)))}
    worst, worst_of_max = 0.0, 0.0
    for k, w in want["gnorms"].items():
        net_max = max(v for n, v in want["gnorms"].items() if n.split("/")[0] == k.split("/")[0])
        err = abs(run["gnorms"][k] - w)
        worst = max(worst, err / w if w else float(err > 0) * np.inf)
        worst_of_max = max(worst_of_max, err / net_max)
    rep["gnorm"], rep["gnorm_of_max"] = worst, worst_of_max
    for key in ("stats", "grad", "flips", "updates", "update_over_lr"):
        rep[key] = 0.0
    for n, lr in zip(nets_of(pair["case"]), lrs):
        if want["stats"][n]:  # all of a net's statistics: a mean near 0 has no scale
            rep["stats"] = max(rep["stats"], _rel_l2(_flat(run["stats"][n]),
                                                     _flat(want["stats"][n])))
        g, gw = run["grads"][n], want["grads"][n]
        flips = np.sign(g) != np.sign(gw)
        steady = (np.abs(gw) >= 1e-6) & ~flips
        d, dw = run["params"][n] - pair["state0"][n], want["params"][n] - pair["state0"][n]
        rep["grad"] = max(rep["grad"], _rel_l2(g, gw))
        rep["flips"] = max(rep["flips"], float(np.linalg.norm(gw[flips]) / np.linalg.norm(gw)))
        rep["updates"] = max(rep["updates"], _rel_l2(d[steady], dw[steady]))
        rep["update_over_lr"] = max(rep["update_over_lr"], float(np.abs(d - dw).max() / lr))
    return {k: float(v) for k, v in rep.items()}


def check_step(pair: dict, bounds: dict) -> None:
    rep = step_report(pair, pair["got"])
    assert rep["update_over_lr"] <= 2.0 + 1e-4, rep
    for key, bound in bounds.items():
        if key == "gnorm":
            continue
        assert rep[key] <= bound, (key, rep)
    # a group norm within its relative bound or within a share of the net's largest
    want = pair["want"]["gnorms"]
    assert sorted(pair["got"]["gnorms"]) == sorted(want)
    for k, w in want.items():
        net_max = max(v for n, v in want.items() if n.split("/")[0] == k.split("/")[0])
        err = abs(pair["got"]["gnorms"][k] - w)
        assert err <= max(bounds["gnorm"] * w, bounds["gnorm_of_max"] * net_max), k


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return step_pair("ddpm-DiffUNet", tmp_path_factory.mktemp("ddpm"))


def test_step_matches_jax_within_its_own_spread(pair):
    check_step(pair, BOUNDS["ddpm-DiffUNet"])
    tr = pair["tr"]
    assert tr.fused_train and tr.compute_dtype == torch.bfloat16
    # every BN took exactly one batch-statistics update, decoders included
    for net in tr.nets.values():
        counts = [int(v) for k, v in net.state_dict().items() if k.endswith("num_batches_tracked")]
        assert counts and set(counts) == {1}


def test_parameters_and_adam_state_stay_f32(pair):
    tr = pair["tr"]
    for name, net in tr.nets.items():
        assert all(p.dtype == torch.float32 for p in net.parameters()), name
        assert all(b.dtype in (torch.float32, torch.int64) for b in net.buffers()), name
    for opt in tr.opts.values():
        assert opt.state and all(s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
                                 for s in opt.state.values())


def test_eval_step_matches_jax(pair):
    """JAX's ``_eval_step`` of a bf16-trained model: the bf16-compute
    modules with their two decoders, ``x_init`` divided by ``c`` in bf16
    (its sigma mask in bf16), the chain in f32 from the same ``x_T``."""
    jtr, tr, batch = pair["jtr"], pair["tr"], pair["batch"]
    assert isinstance(tr.enhancer, ComputeEnhancer)
    rng = jax.random.PRNGKey(5)
    audio, label, loss, diag = jtr._eval_step(
        jtr.state, *jtr.put_batch(batch.noisy, batch.clean, batch.frame_nums), rng)
    x_T = np.array(jax.random.normal(jax.random.split(rng)[0], audio.shape))[None]
    for name in nets_of(pair["case"]):  # JAX's state after its step
        tr.nets[name].load_state_dict(flax_to_state_dict(
            tr.nets[name], _np(jtr.state[name]), batches_tracked=1))
    g_audio, g_label, g_loss, g_diag = tr._eval_step(*torch_batch(batch),
                                                     x_T=torch.from_numpy(x_T))
    assert g_audio.dtype == torch.float32
    assert rel_rms(g_audio.numpy(), np.asarray(audio)) <= 2e-2
    # the label is f32 in both (the bar of the f32 eval test)
    assert np.abs(g_label.numpy() - np.asarray(label)).max() <= 2.5e-4 * np.abs(label).max()
    assert abs(float(g_loss) - float(loss)) <= 2e-2 * abs(float(loss))
    assert sorted(g_diag) == sorted(diag)
    for k in diag:
        scale = 1.0 if k == "res_cos" else abs(float(diag[k]))
        assert abs(float(g_diag[k]) - float(diag[k])) <= 2e-2 * scale, k


def _tool():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(ROOT, "tools", "jax_ckpt_to_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_jax_checkpoint_takes_the_same_next_step(pair, tmp_path):
    """JAX's bf16 trainer's checkpoint after its step holds f32 parameters
    and Adam state, as its f32 trainer's; ``tools/jax_ckpt_to_torch.py``
    (``convert.py::payload_from_jax``, unchanged) carries it into a bf16
    port trainer, which takes JAX's next step."""
    jtr, batch = pair["jtr"], pair["batch"]
    jtr.ckpt.save_best(jtr.ckpt_payload())
    payload = _tool().restore_jax(jtr.run.checkpoint_dir, "best")[0]
    assert all(np.asarray(a).dtype == np.float32
               for n in ("dis", "ddpm") for a in jax.tree.leaves(payload["state"][n]["params"]))
    tr = port_trainer(pair["case"], tmp_path, jtr.run.data_root)
    _tool().main([jtr.run.checkpoint_dir, tr.run.checkpoint_dir])
    assert tr.load_best() and tr.step == 1
    assert all(p.dtype == torch.float32 for n in tr.nets.values() for p in n.parameters())
    rng = jax.random.PRNGKey(12)
    jstate, *losses, gnorms = jtr._train_step(jtr.state, *jtr.put_batch(
        batch.noisy, batch.clean, batch.frame_nums), rng)
    draws = _jax_draws(rng, jtr.exp.diffusion, (2, CHUNK // 160 + 1, 161, 2))
    *got_losses, _ = tr._train_step(*torch_batch(batch), draws=draws)
    np.testing.assert_allclose([float(v) for v in got_losses], [float(v) for v in losses],
                               rtol=BOUNDS["ddpm-DiffUNet"]["loss"])


def test_six_bf16_steps_lower_the_prior_loss(pair, tmp_path):
    tr = port_trainer(pair["case"], tmp_path, pair["jtr"].run.data_root)
    batch = torch_batch(pair["batch"])
    losses = [float(tr._train_step(*batch, norms=False)[1]) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for n in tr.nets.values() for p in n.parameters())
