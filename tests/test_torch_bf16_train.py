"""The bf16-compute forwards of bf16 training against flax's (CPU).

bf16 training (``train.compute_dtype: bfloat16``) builds each JAX model
with ``dtype=bfloat16`` and keeps its variables float32; the port runs the
module's ``models/precision.py::compute_view`` on its own float32
parameters.  Flax variables of each model (its own init, leaves filled
with one constant moved off it and BatchNorm statistics randomised:
``test_torch_priors.py::perturb``) are carried into the port by
``convert.py``; both take the same seeded input, B = 2, T = 12 frames.

Bounds (relative RMS of the output against JAX's jitted forward, the one
its trainer runs): 2e-2, the bf16 serving tests' bound.  JAX's own jitted
and op-by-op (``jax.disable_jit``) forwards sit, in train mode (batch
statistics over 24 rows, which amplify a flipped rounding) / eval mode:
``DiffUNet`` 1.2e-2 / 1.8e-3, ``DiffUNet1`` 1.1e-2 / 1.9e-3, ``Nocon``
1.0e-2 / 1.9e-3, GCRN 9.8e-3 / 2.5e-3, GRN 1.9e-2 / 2.7e-3 apart, and the
port sits as far from the jitted one (``python3 tools/bf16_train_probe.py
forward``, on the CPU; ROADMAP Queue 3), all within 2e-2.  The new
BatchNorm statistics within 2e-2 relative L2 (measured: 6e-3 for the
DiffUNet family, 2.5e-4 for GCRN, 1.1e-2 for GRN).

* every model's train-mode forward and new BatchNorm statistics, and its
  eval-mode forward (DB-AIAT's four variants: ``test_torch_bf16_train_dbaiat.py``;
  the DiffUNet family's dual train forward: ``test_torch_bf16_train_dual.py``);
* the view shares the module's f32 parameters and statistics, and the f32
  path is the module itself;
* flax's train-mode BatchNorm at ``dtype=bfloat16``: statistics in f32
  from the bf16 input, f32 running statistics, the output rounded once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prior_diffuse_tpu.models  # noqa: F401  (registers the models)
from prior_diffuse_tpu.registry import MODELS as JMODELS
from prior_diffuse_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from prior_diffuse_tpu_torch.models import layers as tl
from prior_diffuse_tpu_torch.models import model_class
from prior_diffuse_tpu_torch.models.precision import compute_dtype, compute_view
from test_torch_priors import perturb, speclike

torch.set_num_threads(min(2, torch.get_num_threads()))

T_FRAMES = 12
BF16 = jnp.bfloat16
FORWARD_RMS = 2e-2
STATS_L2 = 2e-2
UNETS = ("DiffUNet", "DiffUNet1", "Nocon")
MODELS = (*UNETS, "GCRN", "GRN")


def make_model(name: str, seed: int = 0):
    """(flax module at ``dtype=bfloat16``, the same at float32, perturbed
    numpy variables, the port's module holding them, numpy inputs)."""
    kw = {"num_steps": 50} if name in ("DiffUNet1", "Nocon") else {}
    jm, jm32 = JMODELS.get(name)(dtype=BF16, **kw), JMODELS.get(name)(**kw)
    variables, args = _variables_and_inputs(name, seed)
    tm = model_class(name)(**kw)
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    return jm, jm32, variables, tm, args


@functools.lru_cache(maxsize=None)
def _variables_and_inputs(name: str, seed: int):
    kw = {"num_steps": 50} if name in ("DiffUNet1", "Nocon") else {}
    jm32 = JMODELS.get(name)(**kw)
    rng = np.random.default_rng(seed)
    if name == "GRN":
        x = np.abs(speclike((2, T_FRAMES, 161), 1))
    else:
        x = speclike((2, T_FRAMES, 161, 2), 1)
    t = np.array([3.5, 17.25], np.float32)
    args = {"DiffUNet1": (x, 0.5 * speclike(x.shape, 2), t), "Nocon": (x, t)}.get(name, (x,))
    init = jax.jit(lambda k, *a: jm32.init(k, *a))(jax.random.PRNGKey(seed),
                                                   *[jnp.asarray(a[:1]) for a in args])
    return perturb(init, rng), args


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    return (request.param, *make_model(request.param))


def _stats_close(tm, want_stats):
    got = jax.tree_util.tree_flatten_with_path(
        state_dict_to_flax(tm, tm.state_dict())["batch_stats"])[0]
    want = jax.tree_util.tree_flatten_with_path(want_stats)[0]
    assert [p for p, _ in got] == [p for p, _ in want] and got
    for (path, g), (_, w) in zip(got, want):
        assert np.asarray(g).dtype == np.float32
        assert rel_l2(g, w) <= STATS_L2, path


def test_train_forward_and_batch_stats_match_flax(model):
    name, jm, _, variables, tm, args = model
    y, new = jax.jit(lambda v, *a: jm.apply(v, *a, train=True, mutable=["batch_stats"]))(
        variables, *[jnp.asarray(a) for a in args])
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    view = compute_view(tm, torch.bfloat16).train()
    got = view(*[torch.from_numpy(a) for a in args])
    assert str(got.dtype).split(".")[-1] == str(y.dtype)  # bf16, f32 for GRN
    assert rel_rms(got.detach().float().numpy(), f32(y)) <= FORWARD_RMS
    _stats_close(tm, new["batch_stats"])


def test_eval_forward_matches_flax(model):
    name, jm, _, variables, tm, args = model
    y = jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
        variables, *[jnp.asarray(a) for a in args])
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    with torch.no_grad():
        got = compute_view(tm, torch.bfloat16).eval()(*[torch.from_numpy(a) for a in args])
    assert rel_rms(got.float().numpy(), f32(y)) <= FORWARD_RMS


def test_compute_view_shares_the_f32_module():
    tm = model_class("GCRN")()
    assert compute_view(tm, torch.float32) is tm
    view = compute_view(tm, torch.bfloat16)
    assert {id(p) for p in view.parameters()} == {id(p) for p in tm.parameters()}
    assert {id(b) for b in view.buffers()} == {id(b) for b in tm.buffers()}
    assert all(p.dtype == torch.float32 for p in view.parameters())
    # the grouped LSTM keeps f32 layers; the convs around it compute in bf16
    assert view.glstm.ln1.layer.weight is tm.glstm.ln1.weight
    assert view.conv1.conv1.dtype == torch.bfloat16
    assert view.glstm.lstm1_0 is not tm.glstm.lstm1_0
    assert type(view.glstm.lstm1_0) is type(tm.glstm.lstm1_0)
    with pytest.raises(ValueError):
        compute_view(tm, torch.float16)
    assert [compute_dtype(n) for n in ("bfloat16", "bf16", "float32", "fp32")] == [
        torch.bfloat16, torch.bfloat16, torch.float32, torch.float32]


def test_batch_norm_bf16_train_mode_matches_flax(rng):
    """flax ``BatchNorm(dtype=bfloat16)`` in train mode on f32 variables:
    the statistics in f32 from the bf16 input (biased variance into the
    f32 running variance), the normalisation in f32, one rounding; and the
    float32 path unchanged, op for op."""
    from prior_diffuse_tpu.models.layers import BatchNorm as JBatchNorm

    x = (1.5 * rng.standard_normal((4, 6, 5, 64)) + 0.3).astype(np.float32)
    xb = np.asarray(jnp.asarray(x).astype(BF16).astype(jnp.float32))
    scale = rng.uniform(0.8, 1.2, 64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    mean0 = rng.standard_normal(64).astype(np.float32) * 0.1
    var0 = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean0, "var": var0}}}
    y, new = JBatchNorm(use_running_average=False, dtype=BF16).apply(
        variables, jnp.asarray(xb).astype(BF16), mutable=["batch_stats"])
    bn = tl.BatchNorm2d(64).train()
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean0),
                     (bn.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    got = bn(torch.from_numpy(xb.copy()).bfloat16().movedim(-1, 1)).movedim(1, -1)
    assert got.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32
    # one rounding of the same f32 value: at most one bf16 ulp apart
    diff = np.abs(got.float().detach().numpy() - f32(y))
    assert (diff <= 2.0 ** -7 * np.abs(f32(y)) + 1e-30).all()
    assert (diff > 0).mean() < 0.01
    for key, t in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_allclose(t.numpy(), np.asarray(new["batch_stats"]["BatchNorm_0"][key]),
                                   rtol=1e-5, atol=1e-7)
    # float32: the same ops as before the bf16 branch existed
    x32 = torch.from_numpy(x).movedim(-1, 1)
    ref, mean, var = tl.batch_norm_train(x32, bn.weight, bn.bias, bn.eps)
    dims = [0, 2, 3]
    m = x32.mean(dims)
    v = torch.clamp((x32 * x32).mean(dims) - m * m, min=0.0)
    s = bn.weight * torch.rsqrt(v + bn.eps)
    want = (x32 - m.view(1, -1, 1, 1)) * s.view(1, -1, 1, 1) + bn.bias.view(1, -1, 1, 1)
    assert torch.equal(ref, want) and torch.equal(mean, m) and torch.equal(var, v)
