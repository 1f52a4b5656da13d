"""GRN's bf16 front end, op by op, against the JAX package's (CPU).

The port's bf16 GRN train step sits about twice as far from JAX's jitted
step as JAX's op-by-op step does (``test_torch_bf16_train_complex.py``,
ROADMAP Queue 3).  ``python3 tools/grn_front_probe.py forward --ops``
traces the train forward layer by layer: the port first leaves JAX's
jitted forward at ``dila2``, where JAX's op-by-op run still agrees with it
bit for bit, and there it differs only in the float32 summation order of
its convolutions (5 of 56,672 elements one bf16 rounding apart; the bias,
the ELU, the flatten and ``bn_in`` round where JAX's jitted step does).
JAX's own forward moves as far when only its summation order changes: run
on its parameters with the front end's channels permuted (the same
function), it sits further from its jitted forward than the port at every
traced point.

So each front-end product after ``dila1`` is held, on JAX's jitted input
at its point, to twice the largest of four samples of JAX's own spread
there: JAX's jitted op with the same sums in another order (its input
channels permuted, seeds 1-4, and a 2-D conv's spatial axes reversed)
against the op itself, relative RMS.  A flipped rounding is rare, so the
input is large enough for each sample to count tens of them: B = 8, T =
48 frames, on the perturbed variables of ``test_torch_bf16_train.py``.
There the port sits 1.4e-5 .. 2.3e-5 from JAX's op and JAX's samples up
to 1.8e-5 .. 2.5e-5 (the bounds 3.7e-5 .. 5.0e-5; ``python3
tools/grn_front_probe.py ops``).  Two wrong ports must miss each bound:
the bias added before the product is rounded (one rounding, as torch's
fused bias does; 2.2e-3 .. 2.8e-3) and the product's two halves of input
channels rounded to bf16 apart before they are summed (2.1e-3 .. 3.2e-3).

``bn_in`` is not compared: with these non-zero conv biases XLA keeps
``conv1d_in``'s bias add in float32 into it, as into every BatchNorm after
a flax Conv module (JAX's jitted ``bn_in`` sits 9.0e-3 from flax's
BatchNorm alone on its captured input; ``tools/grn_front_probe.py bn``,
ROADMAP Queue 3), where the port rounds the add as flax's module does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from prior_diffuse_tpu.models import layers as jl
from prior_diffuse_tpu_torch.models.precision import compute_view
from test_torch_bf16_train import BF16, make_model, rel_rms
from test_torch_priors import speclike

torch.set_num_threads(min(2, torch.get_num_threads()))

# the front end's products after the first: (kind, features, dilation, padding)
OPS = {
    "dila2": (2, 16, (1, 1), ((2, 2), (2, 2))),
    "dila3": (2, 32, (1, 2), ((2, 2), (4, 4))),
    "dila4": (2, 32, (1, 4), ((2, 2), (8, 8))),
    "conv1d_in": (1, 256, (1,), "VALID"),
}
WRONG = ("bias_rounded_once", "halves_rounded_apart")
SHAPE = (8, 48)  # batch, frames
SEEDS = (1, 2, 3, 4)


def record_inputs(next_fun, args, kwargs, context):
    """A flax method interceptor that sows each named module's input into
    ``intermediates`` as ``input``."""
    if context.method_name == "__call__" and args and context.module.name:
        context.module.sow("intermediates", "input", args[0])
    return next_fun(*args, **kwargs)


def captured(model, variables, x, eager: bool = False):
    """JAX's bf16 train-mode forward of ``model`` (a flax GRN) on
    ``variables`` and ``x``, jitted or op by op: ``(output, new batch
    statistics, {module name: {"input": ..., "__call__": ...}})``, each
    module's input recorded by :func:`record_inputs`, its output by
    ``capture_intermediates``."""
    import flax.linen as nn

    def fwd(v, x):
        with nn.intercept_methods(record_inputs):
            return model.apply(v, x, train=True, capture_intermediates=True,
                               mutable=["batch_stats", "intermediates"])

    if eager:
        with jax.disable_jit():
            y, aux = fwd(variables, jnp.asarray(x))
    else:
        y, aux = jax.jit(fwd)(variables, jnp.asarray(x))
    return y, aux["batch_stats"], aux["intermediates"]


def jax_op(name: str):
    kind, features, dilation, padding = OPS[name]
    if kind == 2:
        return jl.conv2d(features, (5, 5), dilation=dilation, padding=padding, dtype=BF16)
    return jl.conv1d(features, 1, dtype=BF16)


def reordered_op(name: str, params, x, seed: int):
    """JAX's jitted op ``name`` with its input channels permuted by a
    permutation drawn from ``seed`` and, for a 2-D conv, both spatial axes
    of its input, kernel and output reversed (its padding is symmetric):
    the same sums in another order."""
    perm = np.random.default_rng(seed).permutation(x.shape[-1])
    k = np.asarray(params["kernel"])[..., perm, :]
    x = jnp.asarray(x)[..., perm]
    flip = (1, 2) if OPS[name][0] == 2 else ()
    if flip:
        k, x = k[::-1, ::-1], jnp.flip(x, flip)
    y = jax.jit(lambda v, x: jax_op(name).apply(v, x))(
        {"params": {"kernel": k, "bias": params["bias"]}}, x)
    return jnp.flip(y, flip) if flip else y


def wrong_port(layer, x: torch.Tensor, wrong: str) -> torch.Tensor:
    """The port's product of ``layer`` on the bf16 ``x`` with a fault."""
    w, b = layer.weight.bfloat16(), layer.bias.bfloat16()
    if wrong == "bias_rounded_once":
        return layer._conv_forward(x, w, b)
    half = x.shape[1] // 2
    y = (layer._conv_forward(x[:, :half], w[:, :half], None)
         + layer._conv_forward(x[:, half:], w[:, half:], None))
    return y + b.view(-1, *(1,) * (y.ndim - 2))


def _to_port(a) -> torch.Tensor:
    """A channels-last JAX bf16 array as the port's channels-first bf16."""
    return torch.from_numpy(np.array(a, np.float32)).movedim(-1, 1).bfloat16()


def _from_port(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().movedim(1, -1).numpy()


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def front():
    """JAX's jitted train forward of GRN on a seeded input: its captured
    points, each op's JAX spread, and the port's bf16 view."""
    jm, _, variables, tm, _ = make_model("GRN")
    x = np.abs(speclike((*SHAPE, 161), 1))
    _, _, mid = captured(jm, variables, x)
    cases = {}
    for name in OPS:
        inp, want = mid[name]["input"][0], _f32(mid[name]["__call__"][0])
        spread = max(rel_rms(_f32(reordered_op(name, variables["params"][name], inp, s)), want)
                     for s in SEEDS)
        cases[name] = (inp, want, spread)
    return cases, mid, compute_view(tm, torch.bfloat16).train()


@pytest.mark.parametrize("name", list(OPS))
def test_front_product_within_jax_reordered_spread(front, name):
    cases, _, view = front
    x, want, spread = cases[name]
    with torch.no_grad():
        got = _from_port(getattr(view, name)(_to_port(x)))
    assert 0 < spread < 1e-4, spread
    assert rel_rms(got, want) <= 2 * spread, (rel_rms(got, want), spread)


@pytest.mark.parametrize("wrong", WRONG)
@pytest.mark.parametrize("name", list(OPS))
def test_wrong_front_product_misses_the_bound(front, name, wrong):
    cases, _, view = front
    x, want, spread = cases[name]
    with torch.no_grad():
        got = _from_port(wrong_port(getattr(view, name).layer, _to_port(x), wrong))
    assert rel_rms(got, want) > 2 * spread, (wrong, rel_rms(got, want), spread)


def test_front_elu_rounds_as_jax(front):
    """The ELU after each front-end conv, on JAX's jitted conv output, gives
    the bits JAX's jitted forward feeds the next conv (elementwise: no sum
    whose order could differ)."""
    _, mid, _ = front
    for name, after in (("dila1", "dila2"), ("dila2", "dila3"), ("dila3", "dila4")):
        got = F.elu(_to_port(mid[name]["__call__"][0]))
        assert np.array_equal(_from_port(got), _f32(mid[after]["input"][0])), name
