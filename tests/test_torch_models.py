"""Port DiffUNet / DiffUNet1 and the weight bridge against flax (CPU).

Flax variables (random init, randomised BN statistics) are converted with
``convert.py`` and the eval-mode forwards compared with flax ``apply`` on
the same inputs, fractional ``t`` included, as conv-by-conv modules and as
the serving forward (``fused_forward.fused_unet_forward``: the encoder as
packed K3 stages, plain version on the CPU).
Bound: 1e-4 * max|ref| (about 40 float32 layers, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu.models import layers as jlayers
from prior_diffuse_tpu.models.diffunet import DiffUNet as JDiffUNet
from prior_diffuse_tpu.models.diffunet import DiffUNet1 as JDiffUNet1
from prior_diffuse_tpu.models.diffunet import Nocon as JNocon
from prior_diffuse_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from prior_diffuse_tpu_torch.models import layers
from prior_diffuse_tpu_torch.models.diffunet import DiffUNet, DiffUNet1, Nocon
from prior_diffuse_tpu_torch.models.fused_forward import fused_unet_forward, pack_unet

T_FRAMES = 11


def _close_rel(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, bound = np.abs(got - want).max(), rel * np.abs(want).max()
    assert err <= bound, f"max|diff| {err:.3g} > {bound:.3g}"


def _randomize_bn(tree, rng):
    for key, value in tree.items():
        if key == "BatchNorm_0":
            value["mean"] = (rng.standard_normal(value["mean"].shape) * 0.1
                             ).astype(np.float32)
            value["var"] = (0.5 + rng.random(value["var"].shape)).astype(np.float32)
        elif isinstance(value, dict):
            _randomize_bn(value, rng)


def make_pair(name, seed=0, cond_channels=2):
    """(flax module, numpy variables, converted port module) for one net."""
    rng = np.random.default_rng(seed)
    x = jnp.zeros((1, T_FRAMES, 161, 2))
    if name == "DiffUNet":
        jm, tm = JDiffUNet(), DiffUNet()
        variables = jm.init(jax.random.PRNGKey(seed), x)
    elif name == "Nocon":
        jm, tm = JNocon(), Nocon()
        variables = jm.init(jax.random.PRNGKey(seed), x, jnp.zeros((1,)))
    else:
        jm, tm = JDiffUNet1(), DiffUNet1(cond_channels=cond_channels)
        cond = jnp.zeros((1, T_FRAMES, 161, cond_channels))
        variables = jm.init(jax.random.PRNGKey(seed), x, cond, jnp.zeros((1,)))
    variables = {k: jax.tree.map(np.array, dict(v)) for k, v in variables.items()}
    _randomize_bn(variables["batch_stats"], rng)
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    return jm, variables, tm.eval()


NAMES = ["DiffUNet", "DiffUNet1"]


@pytest.fixture(scope="module")
def nets():
    return {name: make_pair(name) for name in NAMES}


@pytest.fixture(params=NAMES)
def pair(request, nets):
    return (request.param, *nets[request.param])


def test_param_counts():
    counts = [sum(p.numel() for p in m.parameters()) for m in (DiffUNet(), DiffUNet1())]
    assert counts == [1_662_565, 2_780_273]


def test_convert_round_trip_is_identity(pair):
    _, _, variables, tm = pair
    back = state_dict_to_flax(tm, tm.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("form", ["modules", "packed"])
def test_forward_matches_flax(pair, form):
    name, jm, variables, tm = pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, T_FRAMES, 161, 2)).astype(np.float32)
    forward = tm if form == "modules" else (
        lambda *args: fused_unet_forward(pack_unet(tm), *args))
    with torch.no_grad():
        if name == "DiffUNet":
            want = jm.apply(variables, jnp.asarray(x), train=False)
            got = forward(torch.from_numpy(x))
        else:
            xi = rng.standard_normal(x.shape).astype(np.float32)
            t = np.asarray([3.7, 21.0], np.float32)
            want = jm.apply(variables, jnp.asarray(x), jnp.asarray(xi),
                            jnp.asarray(t), train=False)
            got = forward(torch.from_numpy(x), torch.from_numpy(xi),
                          torch.from_numpy(t))
    _close_rel(got.numpy(), want)


def test_time_embedding_matches_jax(nets):
    _, variables, tm = nets["DiffUNet1"]
    te_vars = {"params": variables["params"]["time_embedding"]}
    jte = jlayers.TimeEmbedding(50)
    table = jte.apply(te_vars, method=lambda m: m.table)
    np.testing.assert_array_equal(tm.time_embedding.table.numpy(), np.asarray(table))
    np.testing.assert_array_equal(layers.time_embedding_table(50), np.asarray(table))
    for t in (np.asarray([0.0, 3.7, 21.0, 48.93], np.float32),
              np.asarray([0, 17, 49], np.int32)):
        want = jte.apply(te_vars, jnp.asarray(t))
        with torch.no_grad():
            got = tm.time_embedding(torch.from_numpy(t).long() if t.dtype == np.int32
                                    else torch.from_numpy(t))
        _close_rel(got.numpy(), want, 1e-5)


def test_rejects_other_frequency_widths():
    with pytest.raises(ValueError):
        DiffUNet()(torch.zeros(1, 4, 160, 2))
