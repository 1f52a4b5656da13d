"""The GCRN and DB-AIAT priors of the port against flax (CPU).

Flax variables of each family (its own init, then every leaf that init
fills with one constant, such as LayerNorm scales, the MHA biases, the
PReLU slopes and ``k1``/``k2``/``k3``, moved off it by 0.1 N(0, 1), and
randomised BatchNorm statistics) are carried into the port by
``convert.py``; both take the same seeded numpy input.  Models at full
width (GCRN's ``Dense(161)`` and its 1024-wide LSTM fix it), B = 2 and
T = 12 frames; layers alone at their models' widths.

* the forward of GCRN and of each DB-AIAT variant, and of LSTM, the
  bidirectional GRU, MHA, LayerNorm, ``LayerNormOverF``, ``GroupNorm1``,
  ``SPConvTranspose2d``, the gated (transposed) convs and the PReLU,
  within 2.5e-4 x max|JAX output| (the bar of the serving path,
  ``PARITY.md``);
* the ``convert.py`` round trip (flax -> port -> flax is the identity);
* each family's parameter count against the reference oracle
  (``tests/test_models.py``);
* the model table holds the JAX registry's names.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu.models import dbaiat as jdb
from prior_diffuse_tpu.models import gcrn as jgcrn
from prior_diffuse_tpu.models import layers as jl
from prior_diffuse_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from prior_diffuse_tpu_torch.models import (MODELS, complex_prior_class, dbaiat, gcrn, layers,
                                            model_class)

# two torch threads a worker process: see test_torch_trainer.py
torch.set_num_threads(min(2, torch.get_num_threads()))

T_FRAMES = 12
RTOL = 2.5e-4
ORACLE = {"GCRN": 9_771_340, "aia_complex_trans_ri": 1_179_030,
          "dual_aia_trans_merge_crm": 2_810_859, "dual_aia_complex_trans": 2_085_935,
          "aia_complex_trans_mag": 906_905}
JAX_CLASSES = {"GCRN": jgcrn.GCRN, "aia_complex_trans_ri": jdb.AiaComplexTransRI,
               "aia_complex_trans_mag": jdb.AiaComplexTransMag,
               "dual_aia_complex_trans": jdb.DualAiaComplexTrans,
               "dual_aia_trans_merge_crm": jdb.DualAiaTransMergeCRM}


def close_rel(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err, bound = np.abs(got - want).max(), rtol * np.abs(want).max()
    assert err <= bound, f"max|diff| {err:.3g} > {bound:.3g}"


def perturb(variables, rng):
    """numpy copy of flax ``variables``: leaves that init fills with one
    value moved off it, BatchNorm statistics randomised."""
    def walk(tree, stats):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = walk(value, stats)
                continue
            value = np.array(value)
            if stats:
                value = ((rng.standard_normal(value.shape) * 0.1) if key == "mean"
                         else 0.5 + rng.random(value.shape))
            elif value.size == 1 or np.all(value == value.flat[0]):
                value = value + 0.1 * rng.standard_normal(value.shape)
            out[key] = value.astype(np.float32)
        return out

    return {c: walk(jax.tree.map(np.array, dict(v)), c == "batch_stats")
            for c, v in variables.items()}


def make_prior(name, seed=0):
    """(flax module, perturbed numpy variables, converted port module)."""
    jm, tm = JAX_CLASSES[name](), model_class(name)()
    x = jnp.zeros((1, T_FRAMES, 161, 2))
    variables = perturb(jm.init(jax.random.PRNGKey(seed), x), np.random.default_rng(seed))
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    return jm, variables, tm.eval()


def speclike(shape, seed):
    """A compressed-spectrum-like input: N(0, 1) with some bins at exactly 0."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[:, :, :3] = 0.0
    return x


@pytest.fixture(scope="module", params=list(ORACLE))
def prior(request):
    return (request.param, *make_prior(request.param, seed=len(request.param)))


def test_model_table_holds_the_jax_registry():
    from prior_diffuse_tpu.registry import MODELS as JMODELS

    assert sorted(MODELS) == JMODELS.names()
    for name in ("GRN", "DiffWave"):  # ported; neither is a complex-spectrum prior
        assert model_class(name) is MODELS[name] and MODELS[name].__name__ == name
        with pytest.raises(ValueError, match="not a complex-spectrum prior"):
            complex_prior_class(name)
    with pytest.raises(KeyError):
        model_class("nope")


@pytest.mark.parametrize("name", list(ORACLE))
def test_param_counts(name):
    assert sum(p.numel() for p in model_class(name)().parameters()) == ORACLE[name]


def test_convert_round_trip_is_identity(prior):
    _, _, variables, tm = prior
    back = state_dict_to_flax(tm, tm.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_forward_matches_flax(prior):
    _, jm, variables, tm = prior
    x = speclike((2, T_FRAMES, 161, 2), 1)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    close_rel(got.numpy(), want)


# ---- layers alone ----------------------------------------------------------------

def _layer_pair(jmod, tmod, x_jax, seed=0):
    # flax.linen.Module.init: the JAX PReLU's ``init`` field shadows the method
    variables = perturb(nn.Module.init(jmod, jax.random.PRNGKey(seed), x_jax),
                        np.random.default_rng(seed))
    tmod.load_state_dict(flax_to_state_dict(tmod, variables))
    return variables, tmod.eval()


def _seq(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


LAYERS = {  # name: (flax module, port module, input shape [N, L, d] or channels-last)
    "lstm": (lambda: jl.LSTM(512), lambda: layers.LSTM(512, 512), (2, T_FRAMES, 512)),
    "bigru": (lambda: jl.GRU(64, bidirectional=True), lambda: layers.GRU(32, 64, True),
              (6, T_FRAMES, 32)),
    "mha": (lambda: jl.MultiHeadAttention(32, 4), lambda: layers.MultiHeadAttention(32, 4),
            (6, T_FRAMES, 32)),
    "layernorm": (lambda: jl.LayerNorm(), lambda: torch.nn.LayerNorm(1024), (2, T_FRAMES, 1024)),
    "prelu": (lambda: jl.PReLU(64), lambda: torch.nn.PReLU(64), (2, T_FRAMES, 80, 64)),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_flax(name):
    make_j, make_t, shape = LAYERS[name]
    x = _seq(shape)
    if name == "layernorm":
        # a mean well off 0, where flax's one-pass variance loses digits:
        # float64 says flax 1.5e-6, torch's two-pass 1.6e-7 at this input
        x = x + 3.0
    variables, tm = _layer_pair(make_j(), make_t(), jnp.asarray(x))
    want = make_j().apply(variables, jnp.asarray(x))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = tm(xt.movedim(-1, 1)).movedim(1, -1) if name == "prelu" else tm(xt)
    close_rel(got.numpy(), want)


@pytest.mark.parametrize("name", ["LayerNormOverF", "GroupNorm1", "SPConvTranspose2d",
                                  "GluConv2d", "GluConvTranspose2d", "DenseBlock"])
def test_conv_layer_matches_flax(name):
    """Channels-last in JAX, NCHW in the port (``GroupNorm1`` is
    channels-last in both)."""
    x = _seq((2, T_FRAMES, 80, 64), seed=3) + 0.5
    jmod, tmod, nchw = {
        "LayerNormOverF": (jdb.LayerNormOverF(), dbaiat.LayerNormOverF(80), True),
        "GroupNorm1": (jdb.GroupNorm1(), dbaiat.GroupNorm1(64), False),
        "SPConvTranspose2d": (jdb.SPConvTranspose2d(64, 2), dbaiat.SPConvTranspose2d(64, 64),
                              True),
        "GluConv2d": (jgcrn.GluConv2d(32), gcrn.GluConv2d(64, 32), True),
        "GluConvTranspose2d": (jgcrn.GluConvTranspose2d(16, output_padding=(0, 1)),
                               gcrn.GluConvTranspose2d(64, 16, (0, 1)), True),
        "DenseBlock": (jdb.DenseBlock(4, 64), dbaiat.DenseBlock(80), True),
    }[name]
    variables, tm = _layer_pair(jmod, tmod, jnp.asarray(x))
    want = jmod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = tm(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) if nchw else tm(xt)
    close_rel(got.numpy(), want)


def test_spconv_reshape_order():
    """Output channel ``j C + c`` at bin ``f`` is channel ``c`` at bin
    ``2 f + j``; the transposed split (``[C, r]``) fails the flax check."""
    sp = dbaiat.SPConvTranspose2d(2, 3, r=2)
    with torch.no_grad():
        sp.conv.weight.zero_()
        sp.conv.bias.copy_(torch.arange(6.0))
        out = sp(torch.zeros(1, 2, 1, 4))  # F: 4 -> 2 -> 4
    # bin 2f + j holds bias j * 3 + c in channel c
    want = torch.tensor([[0.0, 3.0, 0.0, 3.0], [1.0, 4.0, 1.0, 4.0], [2.0, 5.0, 2.0, 5.0]])
    assert torch.equal(out[0, :, 0], want), out[0, :, 0]


def test_glstm_flattens_c_major_and_interleaves_groups():
    """The bottleneck's feature ``c F + f`` (c-major) feeds group ``(c F +
    f) // 512``, and the first layer's outputs are interleaved: feature
    ``2 k + g`` of ``ln1``'s input is feature ``k`` of group ``g``."""
    g = gcrn.GLSTM()
    seen = {}
    for i in range(2):
        getattr(g, f"lstm1_{i}").register_forward_hook(
            lambda m, args, out, i=i: seen.setdefault(f"in{i}", args[0]))
    g.ln1.register_forward_hook(lambda m, args, out: seen.setdefault("ln1", args[0]))
    x = torch.randn(1, 256, 3, 4)
    with torch.no_grad():
        g(x)
    flat = x.permute(0, 2, 1, 3).reshape(1, 3, 1024)
    assert torch.equal(seen["in0"], flat[..., :512]) and torch.equal(seen["in1"], flat[..., 512:])
    with torch.no_grad():
        outs = [getattr(g, f"lstm1_{i}")(seen[f"in{i}"]) for i in range(2)]
    assert torch.equal(seen["ln1"][..., 0::2], outs[0])
    assert torch.equal(seen["ln1"][..., 1::2], outs[1])
