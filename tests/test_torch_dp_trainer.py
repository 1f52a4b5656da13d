"""The three trainers on a data-parallel group of two ranks (CPU, gloo).

The ranks are real processes (``tests/test_torch_dp_worker.py``, a file
rendezvous, every rank killed and the fixture failed after 240 s: each rank
builds a full-width trainer on one thread, beside the suite's other
workers).

* The slice: ``ComplexDDPMTrainer`` (``--joint --sigma``) takes one step on
  a ragged global batch of 3 (padded to 4: JAX's pad row, ``frame_nums``
  0, seen by BatchNorm, masked out of the losses) against JAX's trainer on
  ``make_mesh(dp=2)``, from the same weights (``convert.py``) with JAX's
  global q-sample draws (each rank takes its rows).  Bounds are
  ``tests/test_torch_train_step.py``'s: losses rtol 1e-5, new BN running
  statistics rtol 1e-5, updates within ``2 * lr`` with the elements of
  opposite gradient sign carrying at most 1e-3 of the gradient's norm; the
  group gradient norms and the same-sign updates at its deltamu and
  conditional rows' 1e-3 (the norms with an atol of 1e-5 of the net's
  largest), not its pirorgrad rows' 1e-4: at this padded batch the step's
  own rounding floor is above 1e-4 (``python3 tools/dp_probe.py``, CPU:
  JAX's step on ``make_mesh(dp=1)`` and ``(dp=2)`` sit 7.1e-4 apart on
  ``gn_ddpm/preprocess/bias``, 2.9e-4 on ``time_embedding/proj1``; the
  port's one-process step moves 1.2e-3 there when its clean batch is
  scaled by 1 + 1e-7 N(0, 1) and sits 3.8e-3 from JAX's; the two ranks
  sit 3.8e-4 from the port's one process and 4.2e-3 from JAX, 1.7e-6
  absolute on a norm of 4.1e-4 in a net whose largest is 0.40: that bias's
  gradient is a sum with cancellation, as the parent file says; the DDPM's
  same-sign updates sit 4.6e-4 from JAX's, the one process's 3.5e-4, and
  the perturbations move the one process's by 2.4e-4 and 3.3e-4).  Both
  ranks hold the same state bit for bit.  Then one cv batch of 3
  (padded to 4) with the JAX chain's global ``x_T``: the eval step (the
  estimate within 2.5e-4 of the largest value, the loss and diagnostics
  within 2.5e-4 of their size, the cosine of 1), and ``evaluate()``
  against JAX's ``evaluate()`` on the same mesh: the cv loss and
  diagnostics as the eval step's, and the six metrics, scored on rank 0
  from the gathered estimate, within 1e-3 (relative; the estimates differ
  by up to 2.5e-4 of their peak).
* ``ComplexTrainer`` (GCRN, ``conf/gcrn.yml``) and ``MagTrainer`` (GRN,
  ``conf/grn.yml``): the 2-rank step on a global batch of 4 equals the
  port's own one-process step on that batch under the same bounds (the
  updates by the sign rule against the one-process gradient); after two
  steps the ranks' parameters and BN statistics agree bit for bit (each
  rank applies the same summed gradient and the same global statistics).
* ``enhance_files`` through the 2-rank ``ComplexDDPMTrainer`` (buckets of
  2 rows, one a rank) equals the one-process trainer's output with the same
  generator within 1e-6 of the peak: the ranks draw the global batch's
  ``x_T`` and keep their rows.
"""

import concurrent.futures
import os

import jax
import numpy as np
import pytest
import torch

import prior_diffuse_tpu.config as jcfg
from prior_diffuse_tpu.data import synthetic
from prior_diffuse_tpu.parallel.mesh import make_mesh
from prior_diffuse_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from prior_diffuse_tpu_torch.data.dataset import PairedWavDataset, _collate
from prior_diffuse_tpu_torch.serving.enhance import enhance_files
from prior_diffuse_tpu_torch.training.complex_trainer import ComplexTrainer
from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer, seeded_nets
from prior_diffuse_tpu_torch.training.mag_trainer import MagTrainer
from test_torch_dp_worker import configs, launch
from test_torch_train_step import _flat, _jax_draws, _jax_grad, _np, _rel_l2, _steady

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 4800
LR_DIS, LR_DDPM = 5e-4, 2e-4
# the slice's group norms and same-sign updates (module docstring)
SLICE_RTOL, SLICE_NORM_ATOL = 1e-3, 1e-5
PRIOR_CHUNK = 1600
SERVE_SEED = 21
TIMEOUT = 240  # seconds for a group of ranks


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return synthetic.write_corpus(str(root), n_train=4, n_test=3,
                                  min_len=6000, max_len=9000, seed=5)


def _batch(corpus, rows, chunk):
    ds = PairedWavDataset(f"{corpus}/noisy_trainset_wav", f"{corpus}/clean_trainset_wav",
                          chunk_length=chunk)
    rng = np.random.default_rng(0)
    b = _collate([ds.load_pair(j, crop=True, rng=rng) for j in range(rows)], chunk)
    return torch.from_numpy(b.noisy), torch.from_numpy(b.clean), torch.from_numpy(b.frame_nums)


def _ddpm_inp(corpus, tmp):
    """The port's side of the slice, and its JAX configuration."""
    return {"run": dict(assets=str(tmp / "torch"), doc="t", data_root=corpus, joint=True,
                        sigma=True),
            "train": dict(batch_size=3, n_epochs=1, chunk_length=CHUNK),
            "optim": dict(lr=LR_DIS), "optim_ddpm": dict(lr=LR_DDPM), "diffusion": {}}


def _wavs():
    rng = np.random.default_rng(9)
    return [torch.from_numpy((0.2 * rng.standard_normal(n)).astype(np.float32))
            for n in (3000, 4100, 5200, 2600)]


@pytest.fixture(scope="module")
def slice_run(corpus, tmp_path_factory):
    """The JAX trainer on ``make_mesh(dp=2)`` and the two ranks, run side by
    side: the ranks start as soon as their inputs exist."""
    from prior_diffuse_tpu.training import ComplexDDPMTrainer as JTrainer

    tmp = tmp_path_factory.mktemp("slice")
    inp = _ddpm_inp(corpus, tmp)
    jexp = jcfg.ExperimentConfig(
        train=jcfg.TrainConfig(**inp["train"]), optim=jcfg.OptimConfig(lr=LR_DIS),
        optim_ddpm=jcfg.OptimConfig(lr=LR_DDPM), diffusion=jcfg.DiffusionConfig())
    jtr = JTrainer(jcfg.RunConfig(assets=str(tmp / "jax"), doc="t", data_root=corpus,
                                  joint=True, sigma=True), jexp, mesh=make_mesh(dp=2))
    state0 = {k: _np(jtr.state[k]) for k in ("dis", "ddpm")}
    nets = dict(zip(("dis", "ddpm"), seeded_nets(0, jexp.diffusion.num_steps, 2)))
    inp["weights"] = {n: flax_to_state_dict(nets[n], state0[n]) for n in nets}

    batch = _batch(corpus, 3, CHUNK)
    rng = jax.random.PRNGKey(11)
    inp["batch"] = batch
    inp["draws"] = tuple(_jax_draws(rng, jexp.diffusion, (4, CHUNK // 160 + 1, 161, 2)))
    cv = next(iter(jtr.cv_loader))
    assert cv.noisy.shape[0] == 3
    inp["cv_batch"] = tuple(torch.from_numpy(a) for a in (cv.noisy, cv.clean, cv.frame_nums))
    eval_rng = jax.random.split(jtr.rng)[1]  # the key evaluate() takes next
    shape = (4, cv.noisy.shape[1] // 160 + 1, 161, 2)
    inp["x_T"] = torch.from_numpy(np.array(
        jax.random.normal(jax.random.split(eval_rng)[0], shape)))[None]
    inp["wavs"], inp["serve_seed"] = _wavs(), SERVE_SEED

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, "ddpm", 2, str(tmp), inp, TIMEOUT)
        noisy, clean, frames = jtr.put_batch(*(a.numpy() for a in batch))
        assert noisy.shape[0] == 4
        jstate, total, l_dis, l_ddpm, gnorms = jtr._train_step(jtr.state, noisy, clean,
                                                               frames, rng)
        jtr.state = jstate
        arrays = jtr.put_batch(cv.noisy, cv.clean, cv.frame_nums)
        audio, label, loss, diag = jtr._eval_step(jstate, *arrays, eval_rng)
        records = []
        jtr.metrics.log = lambda metrics, step=None: records.append(dict(metrics))
        cv_loss = jtr.evaluate()
        outs = ranks.result()
    return dict(inp=inp, nets=nets, state0=state0, jstate=jstate, outs=outs,
                step=(float(total), float(l_dis), float(l_ddpm),
                      {k: float(v) for k, v in gnorms.items()}),
                eval=(np.asarray(audio), np.asarray(label), float(loss),
                      {k: float(v) for k, v in diag.items()}),
                cv_loss=cv_loss, records=records)


def test_slice_step_losses_and_norms_match_jax(slice_run):
    total, l_dis, l_ddpm, gnorms = slice_run["step"]
    for out in slice_run["outs"]:
        rec = out["ddpm"]["step"]
        np.testing.assert_allclose(rec["losses"], [total, l_dis, l_ddpm], rtol=1e-5, atol=1e-7)
        assert sorted(rec["gnorms"]) == sorted(gnorms)
        for k, want in gnorms.items():
            net_max = max(v for n, v in gnorms.items() if n.split("/")[0] == k.split("/")[0])
            np.testing.assert_allclose(rec["gnorms"][k], want, rtol=SLICE_RTOL,
                                       atol=SLICE_NORM_ATOL * net_max, err_msg=k)


def test_slice_step_batch_stats_match_jax(slice_run):
    rec = slice_run["outs"][0]["ddpm"]["step"]
    for name, net in slice_run["nets"].items():
        got = state_dict_to_flax(net, rec["state"][name])["batch_stats"]
        want = _np(slice_run["jstate"][name]["batch_stats"])
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (path, g), (_, w) in zip(flat_g, flat_w):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, err_msg=f"{name} {path}")


def _updates_follow(d_got, d_want, g_got, g_want, steady, lr, rtol=1e-4):
    """The update rule of ``tests/test_torch_train_step.py``: elementwise
    within ``2 * lr``; the elements of opposite gradient sign carry at most
    1e-3 of the gradient's norm; relative L2 over the steady same-sign
    elements within ``rtol``."""
    assert np.abs(d_got - d_want).max() <= 2 * lr
    flips = np.sign(g_got) != np.sign(g_want)
    assert np.linalg.norm(g_want[flips]) <= 1e-3 * np.linalg.norm(g_want)
    assert _rel_l2(d_got[steady & ~flips], d_want[steady & ~flips]) <= rtol


def test_slice_step_updates_match_jax(slice_run):
    outs, jstate, state0 = slice_run["outs"], slice_run["jstate"], slice_run["state0"]
    for name, lr in (("dis", LR_DIS), ("ddpm", LR_DDPM)):
        net = slice_run["nets"][name]
        rec = outs[0]["ddpm"]["step"]
        old = _flat(state0[name]["params"])
        d_got = _flat(state_dict_to_flax(net, rec["state"][name])["params"]) - old
        d_want = _flat(_np(jstate[name]["params"])) - old
        g_got = _flat(state_dict_to_flax(net, rec["grad"][name])["params"])
        _updates_follow(d_got, d_want, g_got, _jax_grad(jstate["opt_" + name]),
                        _steady(jstate["opt_" + name]), lr, SLICE_RTOL)
    # one global gradient, one update: the ranks hold the same state
    for name, sd in outs[0]["ddpm"]["step"]["state"].items():
        other = outs[1]["ddpm"]["step"]["state"][name]
        assert all(torch.equal(v, other[k]) for k, v in sd.items()), name


def test_slice_eval_step_matches_jax(slice_run):
    audio, label, loss, diag = slice_run["eval"]
    got = [o["ddpm"]["eval_step"] for o in slice_run["outs"]]
    for key, want in (("audio", audio), ("label", label)):
        rows = torch.cat([g[key] for g in got]).numpy()
        assert rows.shape == want.shape  # 4 rows: 3 and the pad row
        assert np.abs(rows[:3] - want[:3]).max() <= 2.5e-4 * np.abs(want[:3]).max()
    for g in got:  # every rank holds the global values
        assert abs(g["loss"] - loss) <= 2.5e-4 * abs(loss)
        assert sorted(g["diag"]) == sorted(diag)
        for k, want in diag.items():
            scale = 1.0 if k == "res_cos" else abs(want)
            assert abs(g["diag"][k] - want) <= 2.5e-4 * scale, k


def test_slice_evaluate_matches_jax(slice_run):
    """``evaluate()`` over the cv split (one batch of 3 on 2 ranks): the cv
    loss and diagnostics on every rank, the six metrics from rank 0."""
    want = {k: v for r in slice_run["records"] for k, v in r.items()}
    for rank, out in enumerate(slice_run["outs"]):
        assert abs(out["ddpm"]["cv_loss"] - slice_run["cv_loss"]) <= 2.5e-4 * slice_run["cv_loss"]
        got = {k: v for r in out["ddpm"]["records"] for k, v in r.items()}
        if rank:  # only rank 0 writes metrics
            assert not got
            continue
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            if isinstance(w, str):
                assert got[k] == w, k
            elif k.endswith("res_cos"):
                assert abs(got[k] - w) <= 2.5e-4, k
            elif k.startswith("test_mean_"):
                assert abs(got[k] - w) <= 1e-3 * max(abs(w), 1.0), k
            else:
                assert abs(got[k] - w) <= 2.5e-4 * abs(w), k


def test_enhance_files_on_two_ranks_is_one_process(slice_run, corpus, tmp_path):
    run, exp = configs({**_ddpm_inp(corpus, tmp_path), "run": dict(
        assets=str(tmp_path / "one"), doc="t", data_root=corpus, joint=True, sigma=True)})
    one = ComplexDDPMTrainer(run, exp, device="cpu")
    wavs = [w.numpy() for w in _wavs()]
    want = enhance_files(one, wavs, torch.Generator().manual_seed(SERVE_SEED), batch_size=2)
    for out in slice_run["outs"]:
        got = out["ddpm"]["served"]
        assert [len(g) for g in got] == [len(w) for w in wavs]
        for g, w in zip(got, want):
            assert np.abs(g.numpy() - w).max() <= 1e-6 * np.abs(w).max()


PRIORS = {"ComplexTrainer": ("gcrn", ComplexTrainer), "MagTrainer": ("grn", MagTrainer)}


@pytest.fixture(scope="module")
def prior_run(corpus, tmp_path_factory):
    """Each prior trainer's step on 2 ranks and in this process, on one
    global batch of 4."""
    tmp = tmp_path_factory.mktemp("priors")
    cases = {name: {"config": os.path.join(ROOT, "conf", f"{yml}.yml"),
                    "train": dict(batch_size=4, n_epochs=1, chunk_length=PRIOR_CHUNK),
                    "run": dict(assets=str(tmp / name), doc="t", data_root=corpus),
                    "batch": _batch(corpus, 4, PRIOR_CHUNK)}
             for name, (yml, _) in PRIORS.items()}
    outs = launch("prior", 2, str(tmp), {"priors": cases}, TIMEOUT)
    one = {}
    for name, (_, cls) in PRIORS.items():
        tr = cls(*configs({**cases[name], "run": dict(assets=str(tmp / f"{name}_one"),
                                                       doc="t", data_root=corpus)}),
                 device="cpu")
        before = {k: v.clone() for k, v in tr.model.state_dict().items()}
        loss, gnorms = tr._train_step(*cases[name]["batch"])
        one[name] = dict(tr=tr, before=before, loss=float(loss),
                         gnorms={k: float(v) for k, v in gnorms.items()},
                         grad={k: p.grad.clone() for k, p in tr.model.named_parameters()
                               if p.grad is not None})
    return outs, one


@pytest.mark.parametrize("name", list(PRIORS))
def test_prior_step_on_two_ranks_is_one_process(prior_run, name):
    outs, one = prior_run
    ref = one[name]
    tr = ref["tr"]
    lr = tr.opt.param_groups[0]["lr"]
    state = tr.model.state_dict()
    for out in outs:
        rec = out["prior"][name]["step"]
        np.testing.assert_allclose(rec["losses"], [ref["loss"]], rtol=1e-5)
        net_max = max(ref["gnorms"].values())
        for k, want in ref["gnorms"].items():
            np.testing.assert_allclose(rec["gnorms"][k], want, rtol=1e-4, atol=1e-6 * net_max,
                                       err_msg=k)
        got = rec["state"]["model"]
        for k, want in state.items():
            if "running" in k:
                np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=1e-5, atol=1e-7,
                                           err_msg=k)
        keys = sorted(ref["grad"])
        cat = lambda d: torch.cat([d[k].flatten() for k in keys]).numpy()
        g_ref = cat(ref["grad"])
        _updates_follow(cat(got) - cat(ref["before"]), cat(state) - cat(ref["before"]),
                        cat(rec["grad"]["model"]), g_ref, np.abs(g_ref) >= 1e-6, lr)


@pytest.mark.parametrize("name", list(PRIORS))
def test_prior_ranks_agree_bit_for_bit_after_two_steps(prior_run, name):
    outs, _ = prior_run
    a, b = (o["prior"][name]["state"]["model"] for o in outs)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
