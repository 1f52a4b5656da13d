"""ComplexDDPMTrainer with a GCRN prior against the JAX trainer (CPU).

The JAX trainer takes any registered prior and serves one that is not a
DiffUNet through its module forward, unpacked (``ddpm_trainer.py:148-155,
249-262, 599-612``); so does the port (``serving/enhancer.py``: the six
DDPM forwards still packed, K3 on the card).  Both trainers on a 1-device
mesh (see ``test_torch_train_step.py``), ``--joint --sigma``, the JAX
initial state of both nets carried into the port by ``convert.py``, a
tiny synthetic corpus, batch 2 x 1600 samples (11 frames):

* ``enhance_batch`` on the same weights and the same initial draw
  ``x_T`` (``jax.random.split(rng)[0]``, recomputed): within 2.5e-4 x
  max|JAX|;
* one joint train step on JAX's q-sample draws: losses rtol 1e-5, group
  gradient norms rtol 1e-4 (or 1e-6 x the net's largest), new BatchNorm
  statistics rtol 1e-5, updates within ``2 * lr`` and 1e-4 relative L2
  over the steady same-sign elements (``test_torch_train_step.py``), for
  the GCRN; for the DDPM net 5e-3 on the norms and the updates.

Why the DDPM net's bounds: its step is chaotic in its input's float32
rounding here (``python3 tools/prior_probe.py ddpm``).  Changing the
clean batch by a relative 1e-7 N(0, 1) moves the port's own DDPM group
norms by up to 1.9e-3 (``time_embedding``; ``preprocess/bias`` 1.1e-3)
in one of two draws, and its gradient to 4.2e-3 relative L2 from JAX's
and its same-sign updates to 2.7e-3, while the GCRN's gradient stays
within 1.6e-5 of JAX's.  The port against JAX unperturbed: DDPM group
norms up to 2.8e-3 (``preprocess/bias``), gradient 1.3e-3, updates
9.4e-4.
"""

import jax
import numpy as np
import pytest
import torch

import prior_diffuse_tpu.config as jcfg
from prior_diffuse_tpu.parallel.mesh import make_mesh
from prior_diffuse_tpu_torch import config as tcfg
from prior_diffuse_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer
from test_torch_complex_trainer import CHUNK, _batch, _torch_batch, corpus  # noqa: F401
from test_torch_train_step import _flat, _jax_draws, _jax_grad, _np, _rel_l2, _steady

torch.set_num_threads(min(2, torch.get_num_threads()))

LR_DIS, LR_DDPM = 5e-4, 2e-4
RTOL = {"dis": 1e-4, "ddpm": 5e-3}  # group norms and steady updates (docstring)


def _exp(module):
    return module.ExperimentConfig(
        train=module.TrainConfig(batch_size=2, n_epochs=1, chunk_length=CHUNK),
        model=module.ModelConfig("GCRN"), optim=module.OptimConfig(lr=LR_DIS),
        optim_ddpm=module.OptimConfig(lr=LR_DDPM))


@pytest.fixture(scope="module")
def pair(corpus, tmp_path_factory):  # noqa: F811 (the corpus fixture)
    """The JAX trainer and the port's, both nets on the JAX initial state."""
    from prior_diffuse_tpu.training import ComplexDDPMTrainer as JTrainer

    tmp = tmp_path_factory.mktemp("gcrn_ddpm")
    flags = dict(doc="t", data_root=corpus, joint=True, sigma=True)
    jtr = JTrainer(jcfg.RunConfig(assets=str(tmp / "jax"), **flags), _exp(jcfg),
                   mesh=make_mesh(dp=1))
    tr = ComplexDDPMTrainer(tcfg.RunConfig(assets=str(tmp / "torch"), **flags), _exp(tcfg),
                            device="cpu")
    assert type(tr.dis).__name__ == "GCRN"
    state0 = {k: _np(jtr.state[k]) for k in ("dis", "ddpm")}
    for name in ("dis", "ddpm"):
        tr.nets[name].load_state_dict(flax_to_state_dict(tr.nets[name], state0[name]))
    return jtr, tr, state0


def test_enhance_batch_matches_jax(pair):
    jtr, tr, _ = pair
    wav = _batch(jtr.run.data_root).noisy
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jtr.enhance_batch(wav, rng))
    x_T = np.array(jax.random.normal(jax.random.split(rng)[0],
                                     (2, CHUNK // 160 + 1, 161, 2)))[None]
    assert tr.enhancer.packs()[0] is None  # the GCRN prior runs unpacked
    got = tr.enhancer.enhance_batch(torch.from_numpy(wav), x_T=torch.from_numpy(x_T)).numpy()
    assert got.shape == wav.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2.5e-4 * np.abs(want).max()


def test_joint_step_matches_jax(pair):
    jtr, tr, state0 = pair
    batch = _batch(jtr.run.data_root)
    rng = jax.random.PRNGKey(11)
    arrays = jtr.put_batch(batch.noisy, batch.clean, batch.frame_nums)
    jstate, total, l_dis, l_ddpm, gnorms = jtr._train_step(jtr.state, *arrays, rng)
    draws = _jax_draws(rng, jtr.exp.diffusion, (2, CHUNK // 160 + 1, 161, 2))
    got = tr._train_step(*_torch_batch(batch), draws=draws)
    np.testing.assert_allclose([float(v) for v in got[:3]],
                               [float(total), float(l_dis), float(l_ddpm)], rtol=1e-5, atol=1e-7)
    want_gn = {k: float(v) for k, v in gnorms.items()}
    assert sorted(got[3]) == sorted(want_gn) and "gn_dis/glstm/lstm1_0" in want_gn
    for k, v in want_gn.items():
        top = max(w for n, w in want_gn.items() if n.split("/")[0] == k.split("/")[0])
        np.testing.assert_allclose(float(got[3][k]), v, rtol=RTOL[k[3:].split("/")[0]],
                                   atol=1e-6 * top, err_msg=k)
    for name, lr in (("dis", LR_DIS), ("ddpm", LR_DDPM)):
        net = tr.nets[name]
        flax_now = state_dict_to_flax(net, net.state_dict())
        for (path, g), (_, w) in zip(
                jax.tree_util.tree_flatten_with_path(flax_now["batch_stats"])[0],
                jax.tree_util.tree_flatten_with_path(_np(jstate[name]["batch_stats"]))[0]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, err_msg=f"{name} {path}")
        old = _flat(state0[name]["params"])
        d_want = _flat(_np(jstate[name]["params"])) - old
        d_got = _flat(flax_now["params"]) - old
        assert np.abs(d_got - d_want).max() <= 2 * lr, name
        g_want = _jax_grad(jstate["opt_" + name])
        g_got = _flat(state_dict_to_flax(net, {n: p.grad for n, p in net.named_parameters()})
                      ["params"])
        flips = np.sign(g_got) != np.sign(g_want)
        assert np.linalg.norm(g_want[flips]) <= 1e-3 * np.linalg.norm(g_want), name
        steady = _steady(jstate["opt_" + name]) & ~flips
        assert _rel_l2(d_got[steady], d_want[steady]) <= RTOL[name], name
