"""The port's data parallelism (``parallel/``) against the JAX package's
``dp`` mesh (CPU).

Ranks are real processes on gloo (``tests/test_torch_dp_worker.py``, a
file rendezvous, every rank killed and the fixture failed after 120 s);
JAX runs here, on the virtual CPU devices of ``conftest.py``.

* ``shard_rows``: each rank's rows of a global batch of 3, 5, 6 or 8 rows
  equal the shard JAX's ``put_batch`` puts on that device of
  ``make_mesh(dp=2)`` and ``(dp=4)``; the pad rows are zero (``frame_nums``
  0).
* ``batch_norm_train`` on 2 and 4 ranks (1-D and 2-D, a global batch of 8)
  against ``flax.linen.BatchNorm`` on the whole batch: the output, the new
  running statistics and the VJP (``x``, scale, bias; the ranks' parameter
  gradients summed) against ``jax.vjp``, all rtol 1e-5 (the VJP with an
  atol of 1e-5 of its largest element: the gradient with respect to ``x``
  is a difference of two terms of its size); outside a group the call is
  the parent's formula bit for bit.
* the five masked losses with ragged ``frame_nums`` (a batch of 5, padded
  to 6 or 8) split over 2 and 4 ranks: the ranks' shares sum to the
  one-process value and to JAX's at rtol 1e-6.
* ``TrainLoader(shard=)``: the ranks' rows of every batch of two epochs,
  concatenated, are the single-process batch bit for bit, on the native and
  the Python paths; the pad rows are zero.
* ``PairedWavDataset(shard=)`` gives JAX's names for counts 1, 2 and 8.
* outside a group nothing issues a collective (``global_sum``,
  ``global_shares``, ``draw_rows`` are the identity); ``initialize``
  without ``torch.distributed.run``'s environment contacts nothing, and a
  local rank without a card of its own raises.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu import losses as jlosses
from prior_diffuse_tpu.data import dataset as jds
from prior_diffuse_tpu.models.layers import BatchNorm as JBatchNorm
from prior_diffuse_tpu.parallel.mesh import batch_sharding, make_mesh
from prior_diffuse_tpu.training.base import TrainerBase as JTrainerBase
from prior_diffuse_tpu_torch import losses as tlosses
from prior_diffuse_tpu_torch.data import dataset as tds
from prior_diffuse_tpu_torch.data import synthetic as tsyn
from prior_diffuse_tpu_torch.models import layers as tl
from prior_diffuse_tpu_torch.parallel import distributed, mesh
from test_torch_dp_worker import launch

torch.set_num_threads(min(2, torch.get_num_threads()))

CHUNK = 4000


def _jax_put_batch(a, dp):
    """JAX's ``put_batch`` on ``make_mesh(dp)``: ``{device: its shard}``."""
    m = make_mesh(dp=dp)
    arr, = JTrainerBase.put_batch(types.SimpleNamespace(mesh=m, batch_shard=batch_sharding(m)), a)
    return [np.asarray(next(s.data for s in arr.addressable_shards if s.device == d))
            for d in m.devices]


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("rows", [3, 5, 6, 8])
def test_shard_rows_is_jax_put_batch(dp, rows):
    rng = np.random.default_rng(rows)
    wav = rng.standard_normal((rows, 7)).astype(np.float32)
    frames = rng.integers(1, 9, rows).astype(np.int32)
    for a in (wav, frames):
        want = _jax_put_batch(a, dp)
        got = [mesh.shard_rows(a, r, dp) for r in range(dp)]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(np.concatenate(got)[:rows], a)
        assert not np.concatenate(got)[rows:].any()  # zero rows, frame_nums 0
        t = [mesh.shard_rows(torch.from_numpy(a), r, dp) for r in range(dp)]
        np.testing.assert_array_equal(torch.cat(t).numpy(), np.concatenate(got))


def _bn_cases():
    rng = np.random.default_rng(7)
    cases = {}
    for name, shape in (("1d", (8, 5, 16)), ("2d", (8, 3, 4, 16))):
        c = shape[-1]
        cases[name] = {
            "x": torch.from_numpy((1.5 * rng.standard_normal(shape) + 0.3).astype(np.float32)),
            "cot": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            "weight": torch.from_numpy(rng.uniform(0.8, 1.2, c).astype(np.float32)),
            "bias": torch.from_numpy(rng.standard_normal(c).astype(np.float32)),
            "running_mean": torch.from_numpy(0.1 * rng.standard_normal(c).astype(np.float32)),
            "running_var": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
        }
    return cases


def _loss_args(world):
    """A batch of 5; the sigma mask with its pad rows as a trainer makes
    them (the mask of an all-zero ``x_init`` is 0.5, not 0)."""
    rng = np.random.default_rng(3)
    b, t, f = 5, 7, 161
    a = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    sigma = np.full((-(-b // world) * world, t, f, 2), 0.5, np.float32)
    sigma[:b] = rng.uniform(0.5, 1.0, (b, t, f, 2))
    return {"mag_e": a(b, t, f).abs(), "mag_l": a(b, t, f).abs(), "com_e": a(b, t, f, 2),
            "com_l": a(b, t, f, 2), "sigma": torch.from_numpy(sigma),
            "frames": torch.tensor([7, 3, 5, 1, 6], dtype=torch.int32)}


@pytest.fixture(scope="module", params=[2, 4], ids=["2_ranks", "4_ranks"])
def ranks(request, tmp_path_factory):
    world = request.param
    inp = {"bn": _bn_cases(), "loss_args": _loss_args(world)}
    outs = launch("bn,losses", world, str(tmp_path_factory.mktemp(f"ranks{world}")), inp)
    return world, inp, outs


@pytest.mark.parametrize("case", ["1d", "2d"])
def test_global_batchnorm_matches_flax(ranks, case):
    world, inp, outs = ranks
    c = inp["bn"][case]
    x = jnp.asarray(c["x"].numpy())
    variables = {"params": {"BatchNorm_0": {"scale": c["weight"].numpy(), "bias": c["bias"].numpy()}},
                 "batch_stats": {"BatchNorm_0": {"mean": c["running_mean"].numpy(),
                                                 "var": c["running_var"].numpy()}}}

    def apply(x, scale, bias):
        v = {**variables, "params": {"BatchNorm_0": {"scale": scale, "bias": bias}}}
        return JBatchNorm(use_running_average=False).apply(v, x, mutable=["batch_stats"])

    params = (variables["params"]["BatchNorm_0"]["scale"], variables["params"]["BatchNorm_0"]["bias"])
    y, new = apply(x, *params)
    _, vjp = jax.vjp(lambda *a: apply(*a)[0], x, *params)
    dx, dw, db = vjp(jnp.asarray(c["cot"].numpy()))
    stats = new["batch_stats"]["BatchNorm_0"]

    got = [o["bn"][case] for o in outs]
    np.testing.assert_allclose(torch.cat([g["y"] for g in got]).numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    for key, want in (("running_mean", stats["mean"]), ("running_var", stats["var"])):
        for g in got:  # every rank holds the global statistics
            np.testing.assert_allclose(g[key].numpy(), np.asarray(want), rtol=1e-5)
    for got_g, want_g in ((torch.cat([g["dx"] for g in got]), dx), *(
            (g[k], w) for g in got for k, w in (("dw", dw), ("db", db)))):
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-5,
                                   atol=1e-5 * np.abs(want_g).max())


def test_batchnorm_without_a_group_is_the_parents_formula():
    """Bit for bit the statistics and output the parent computed."""
    c = _bn_cases()["2d"]
    x = c["x"].movedim(-1, 1)
    y, mean, var = tl.batch_norm_train(x, c["weight"], c["bias"], 1e-5)
    xf = x.float()
    dims = [0, 2, 3]
    want_mean = xf.mean(dims)
    want_var = torch.clamp((xf * xf).mean(dims) - want_mean * want_mean, min=0.0)
    scale = c["weight"] * torch.rsqrt(want_var + 1e-5)
    want_y = (xf - want_mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1) + c["bias"].view(1, -1, 1, 1)
    for g, w in ((y, want_y), (mean, want_mean), (var, want_var)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["mag_mse_loss", "mag_mae_loss", "com_mse_loss",
                                  "com_mse_sigma_loss", "com_mag_mse_loss"])
def test_global_losses_sum_to_the_whole_batch(ranks, name):
    world, inp, outs = ranks
    a = inp["loss_args"]
    kind = "mag" if name.startswith("mag") else "com"
    args = [a[f"{kind}_e"], a[f"{kind}_l"], a["frames"]] + (
        [a["sigma"][:5]] if name == "com_mse_sigma_loss" else [])
    one = float(getattr(tlosses, name)(*args))
    jax_value = float(getattr(jlosses, name)(*(jnp.asarray(t.numpy()) for t in args)))
    shares = [float(o["losses"]["share"][name]) for o in outs]
    totals = [float(o["losses"]["total"][name]) for o in outs]
    assert totals == [totals[0]] * world  # every rank holds the same sum
    np.testing.assert_allclose([sum(shares), totals[0]], [one, one], rtol=1e-6)
    np.testing.assert_allclose(totals[0], jax_value, rtol=1e-6)
    if world == 4:  # rank 3 holds only pad rows (frame_nums 0): no share
        assert shares[3] == 0.0


def test_hooks_are_the_identity_without_a_group():
    x = torch.arange(4.0)
    assert mesh.current() is None
    assert mesh.global_sum(x) is x
    assert mesh.global_shares(x, x) == (x, x)
    g = torch.Generator().manual_seed(3)
    want = torch.randn((2, 3), generator=torch.Generator().manual_seed(3))
    assert torch.equal(mesh.draw_rows(lambda s: torch.randn(s, generator=g), (2, 3)), want)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    return tsyn.write_corpus(root, n_train=11, n_test=2, min_len=3000, max_len=6000, seed=5)


def _dataset(module, corpus, shard=None):
    return module.PairedWavDataset(f"{corpus}/noisy_trainset_wav",
                                   f"{corpus}/clean_trainset_wav", chunk_length=CHUNK,
                                   shard=shard)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("world", [2, 4])
def test_train_loader_shards_are_the_single_process_batch(corpus, native, world):
    ds = _dataset(tds, corpus)
    whole = tds.TrainLoader(ds, 3, seed=4, native=native)
    shards = [tds.TrainLoader(ds, 3, seed=4, native=native, shard=(r, world))
              for r in range(world)]
    for _ in range(2):  # the permutation and the crop draws go on across epochs
        want = list(whole)
        got = [list(s) for s in shards]
        assert len(want) == 3 and all(len(g) == 3 for g in got)
        for k, w in enumerate(want):
            for field in ("noisy", "clean", "frame_nums", "wav_lens", "scales"):
                rows = np.concatenate([getattr(g[k], field) for g in got])
                assert len(rows) == -(-3 // world) * world
                np.testing.assert_array_equal(rows[:3], getattr(w, field))
                assert not rows[3:].any()
    assert whole.native_batches == (6 if native else 0)
    assert all(s.native_batches == whole.native_batches for s in shards)


@pytest.mark.parametrize("count", [1, 2, 8])
def test_dataset_shard_names_are_jax(corpus, count):
    for i in range(count):
        assert _dataset(tds, corpus, (i, count)).names == _dataset(jds, corpus, (i, count)).names


def test_initialize_alone_contacts_nothing(monkeypatch):
    """Without ``torch.distributed.run``'s environment ``initialize`` is a
    no-op, as the JAX package's is on one host."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)

    def boom(*args, **kwargs):
        raise AssertionError("initialize() must not contact a rendezvous")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    assert distributed.initialize() is False
    assert distributed.data_shard() == (0, 1) and distributed.is_main()
    assert distributed.local_device("cpu") == torch.device("cpu")


def test_a_local_rank_without_a_card_raises(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", str(torch.cuda.device_count()))
    with pytest.raises(RuntimeError, match="no card of its own"):
        distributed.local_device("cuda")
    assert distributed.local_device("cpu") == torch.device("cpu")
