"""A JAX trainer's checkpoint carried into the port (CPU).

For the pirorgrad and the deltamu system: the JAX ``ComplexDDPMTrainer``
(1-device mesh, batch 2 x 4800, ``--joint --sigma``) takes two train
steps on a tiny synthetic corpus, halves its learning rates once
(``_halve_lrs``), records a plateau state and saves ``best``;
``tools/jax_ckpt_to_torch.py`` converts it into the checkpoint directory
of a port trainer of the same configuration, whose ``load_best`` then
shows:

* parameters, BatchNorm statistics and both Adam states (moments, step,
  learning rate, L2) equal to the JAX state within 1e-7, and the step
  and plateau state equal; the packed serving operands rebuilt;
* ``enhance_batch`` within 2.5e-4 x max|ref| of the JAX trainer's
  ``enhance_batch`` on its restored state (the chain's initial draw
  handed over, as in ``test_torch_enhance.py``);
* the port's optimizers, given the gradient of JAX's next step, move
  each net as that step did (1e-4 relative L2): the Adam states carry;
* the next train step itself, on JAX's q-sample draws: losses within
  1e-5, each net's gradient within 1e-3 relative L2, every update within
  ``2 * lr`` (:func:`test_next_step_matches_jax` says why the updates are
  not held in L2).
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
from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer
from test_torch_train_step import (CHUNK, LR_DDPM, LR_DIS, _adam, _batch, _exp, _flat,
                                   _jax_draws, _rel_l2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"pirorgrad": dict(), "deltamu": dict(pirorgrad=False, deltamu=True)}

torch.set_num_threads(min(2, torch.get_num_threads()))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(ROOT, "tools", "jax_ckpt_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return synthetic.write_corpus(str(root), n_train=2, n_test=2,
                                  min_len=6000, max_len=9000, seed=5)


@pytest.fixture(scope="module", params=list(MODES))
def bridged(request, corpus, tmp_path_factory):
    """The JAX trainer after two steps, a halving and a saved ``best``, and
    the port's trainer after ``load_best`` of the converted checkpoint."""
    from prior_diffuse_tpu.training import ComplexDDPMTrainer as JTrainer

    diff_kw = MODES[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    flags = dict(joint=True, sigma=True, doc="t", data_root=corpus)
    jtr = JTrainer(jcfg.RunConfig(assets=str(tmp / "jax"), **flags), _exp(jcfg, diff_kw),
                   mesh=make_mesh(dp=1))
    batch = _batch(corpus)
    arrays = jtr.put_batch(batch.noisy, batch.clean, batch.frame_nums)
    for i in range(2):
        jtr.state = jtr._train_step(jtr.state, *arrays, jax.random.PRNGKey(30 + i))[0]
        jtr.step += 1
    jtr._halve_lrs()
    for loss in (1.5, 1.25, 1.375):  # best 1.25, one bad epoch
        jtr.plateau.update(loss)
    jtr.ckpt.save_best(jtr.ckpt_payload())

    tr = ComplexDDPMTrainer(tcfg.RunConfig(assets=str(tmp / "torch"), **flags),
                            _exp(tcfg, diff_kw), device="cpu")
    packs_before = tr.enhancer.packs()
    _tool().main([jtr.run.checkpoint_dir, tr.run.checkpoint_dir])
    assert tr.load_best()
    return dict(mode=request.param, jtr=jtr, tr=tr, batch=batch,
                packs_before=packs_before, state=jax.tree.map(np.array, jtr.state))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_close(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7, err_msg=f"{what} {path}")


def test_state_is_carried(bridged):
    tr, jtr, state = bridged["tr"], bridged["jtr"], bridged["state"]
    assert type(tr.ddpm).__name__ == ("Nocon" if bridged["mode"] == "deltamu" else "DiffUNet1")
    for name in ("dis", "ddpm"):
        net, opt = tr.nets[name], tr.opts[f"opt_{name}"]
        _assert_trees_close(state_dict_to_flax(net, net.state_dict()), state[name], name)
        assert all(int(v) == 2 for k, v in net.state_dict().items()
                   if k.endswith("num_batches_tracked"))
        adam = _adam(state[f"opt_{name}"])
        assert int(adam.count) == 2
        params = dict(net.named_parameters())
        for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            moment = state_dict_to_flax(net, {n: opt.state[p][key] for n, p in params.items()})
            _assert_trees_close(moment["params"], tree, f"{name} {key}")
        assert all(float(opt.state[p]["step"]) == 2.0 for p in params.values())
        hyper = state[f"opt_{name}"].hyperparams
        for group in opt.param_groups:
            assert np.float32(group["lr"]) == np.float32(hyper["lr"])
            assert np.float32(group["weight_decay"]) == np.float32(hyper["l2"])
    assert np.float32(tr.opt_dis.param_groups[0]["lr"]) == np.float32(LR_DIS / 2)
    assert tr.step == jtr.step == 2
    assert (tr.plateau.prev_loss, tr.plateau.best_loss, tr.plateau.bad_epochs) == (
        jtr.plateau.prev_loss, jtr.plateau.best_loss, jtr.plateau.bad_epochs) == (1.375, 1.25, 1)
    # no torch state for the JAX key: the generator is seeded from --seed
    fresh = torch.Generator().manual_seed(tr.run.seed ^ 0x5EED)
    assert torch.equal(tr.gen.get_state(), fresh.get_state())
    assert tr.enhancer.packs() is not bridged["packs_before"]


def test_converted_checkpoint_serves_as_jax(bridged):
    jtr, tr, batch = bridged["jtr"], bridged["tr"], bridged["batch"]
    assert jtr.load_best()
    wav = batch.noisy / np.sqrt(np.mean(batch.noisy.astype(np.float64) ** 2, axis=1,
                                        keepdims=True)).astype(np.float32)
    rng = jax.random.PRNGKey(21)
    want = np.asarray(jtr.enhance_batch(jnp.asarray(wav), rng))
    x_T = np.array(jax.random.normal(jax.random.split(rng)[0],
                                     (2, CHUNK // 160 + 1, 161, 2)))[None]
    got = tr.enhancer.enhance_batch(wav, x_T=torch.from_numpy(x_T)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err, bound = np.abs(got - want).max(), 2.5e-4 * np.abs(want).max()
    assert err <= bound, f"max|diff| {err:.3g} > {bound:.3g}"


def _jax_step(bridged, rng):
    """JAX's next step from the saved state: ``(new state, losses)``."""
    jtr, batch = bridged["jtr"], bridged["batch"]
    arrays = jtr.put_batch(batch.noisy, batch.clean, batch.frame_nums)
    out = jtr._train_step(jax.tree.map(jnp.asarray, bridged["state"]), *arrays, rng)
    return jax.tree.map(np.array, out[0]), [float(v) for v in out[1:4]]


def _jax_grads(state, jstate, name):
    """The gradient plus ``l2 * w`` of JAX's step from ``state`` to
    ``jstate``, as a flax tree, from the first moments before and after."""
    return jax.tree.map(lambda new, old: (new - 0.9 * old) / 0.1,
                        _adam(jstate[f"opt_{name}"]).mu, _adam(state[f"opt_{name}"]).mu)


def test_adam_carry_takes_jax_update(bridged):
    """The converted Adam states (moments, count, halved learning rate, L2)
    turn JAX's gradient into JAX's update: the port's optimizer, given the
    gradient of JAX's next step, moves each net as JAX's step did."""
    tr, state = bridged["tr"], bridged["state"]
    jstate, _ = _jax_step(bridged, jax.random.PRNGKey(40))
    snap = copy.deepcopy(tr.ckpt_payload())
    try:
        for name in ("dis", "ddpm"):
            net, opt = tr.nets[name], tr.opts[f"opt_{name}"]
            grads = flax_to_state_dict(net, {"params": _jax_grads(state, jstate, name)})
            l2 = opt.param_groups[0]["weight_decay"]
            with torch.no_grad():
                for n, p in net.named_parameters():  # torch adds the decay itself
                    p.grad = grads[n] - l2 * p
            opt.step()
            old = _flat(state[name]["params"])
            d_want = _flat(jstate[name]["params"]) - old
            d_got = _flat(state_dict_to_flax(net, net.state_dict())["params"]) - old
            assert _rel_l2(d_got, d_want) <= 1e-4, name
    finally:
        tr.restore_payload(snap)


def test_next_step_matches_jax(bridged):
    """The next train step itself, on the same q-sample draws: the losses,
    each net's gradient within 1e-3 relative L2 (``chip_smoke.py``'s bound
    for a step, which is chaotic in its rounding) and its update within
    ``2 * lr`` per element.  The updates are not held in L2: after two
    steps Adam divides by ``sqrt(v)``, which is small where the gradient
    has been, so the gradient's difference (3.6e-4 / 7.7e-4 relative L2
    for the DDPM, pirorgrad / deltamu) reaches the update as 2.8e-3 /
    4.1e-3; :func:`test_adam_carry_takes_jax_update` holds the update that
    the carried state makes of one gradient."""
    tr, batch, state = bridged["tr"], bridged["batch"], bridged["state"]
    rng = jax.random.PRNGKey(40)
    jstate, want = _jax_step(bridged, rng)
    draws = _jax_draws(rng, bridged["jtr"].exp.diffusion, (2, CHUNK // 160 + 1, 161, 2))
    got = tr._train_step(torch.from_numpy(batch.noisy), torch.from_numpy(batch.clean),
                         torch.from_numpy(batch.frame_nums).long(), draws=draws)
    np.testing.assert_allclose([float(v) for v in got[:3]], want, rtol=1e-5)
    for name, lr in (("dis", LR_DIS / 2), ("ddpm", LR_DDPM / 2)):
        net = tr.nets[name]
        g_want = _flat(_jax_grads(state, jstate, name))
        l2 = tr.opts[f"opt_{name}"].param_groups[0]["weight_decay"]
        g_got = _flat(state_dict_to_flax(  # the JAX gradient includes the decay
            net, {n: p.grad + l2 * p for n, p in net.named_parameters()})["params"])
        assert _rel_l2(g_got, g_want) <= 1e-3, name
        old = _flat(state[name]["params"])
        d_want = _flat(jstate[name]["params"]) - old
        d_got = _flat(state_dict_to_flax(net, net.state_dict())["params"]) - old
        assert np.abs(d_got - d_want).max() <= 2 * lr, name


def test_payload_from_jax_refuses_what_does_not_fit():
    """A tree of another net, or an optimizer state that is not the JAX
    package's ``torch_adam``, is refused, not loaded in part."""
    from prior_diffuse_tpu_torch.convert import adam_from_optax, payload_from_jax
    from prior_diffuse_tpu_torch.models.diffunet import DiffUNet, DiffUNet1
    from prior_diffuse_tpu_torch.training.optim import torch_adam
    from test_torch_models import make_pair

    (_, dis_vars, _), (_, nocon_vars, nocon) = make_pair("DiffUNet"), make_pair("Nocon")
    meta = {"step": np.array(0), "plateau_prev": np.array(1.0), "plateau_best": np.array(1.0),
            "plateau_bad": np.array(0)}
    nets = {"dis": DiffUNet(), "ddpm": DiffUNet1()}
    with pytest.raises(ValueError, match="does not fit"):
        payload_from_jax({"state": {"dis": dis_vars, "ddpm": nocon_vars}, "meta": meta}, nets,
                         {})
    opt = torch_adam(nocon.parameters(), 1e-3)
    sgd_like = {"count": np.array(1), "hyperparams": {"lr": np.array(1e-3)},
                "inner_state": [None]}
    with pytest.raises(ValueError, match="torch_adam"):
        adam_from_optax(nocon, sgd_like, opt.state_dict())
