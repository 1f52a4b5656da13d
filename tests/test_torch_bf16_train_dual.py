"""The DiffUNet family's bf16 train forward through the dual decoder
against flax's (CPU).

``models/fused_forward.py::dual_train_forward`` is the port of JAX's
``dual_train_forward`` (``fused_forward.py:285-337``), the forward the
DDPM trainer takes for the DiffUNet family in bf16: the two decoders as one
block-diagonal chain packed inside the forward from the canonical
``de_real`` / ``de_imag`` parameters, each stage's BatchNorm one
128-channel train-mode BatchNorm over ``[real | imag]``.  On the perturbed
variables and inputs of ``test_torch_bf16_train.py`` (B = 2, T = 12), at
that file's bounds: 2e-2 relative RMS of the output (JAX's own jitted and
op-by-op train forwards sit 1.0e-2 .. 1.2e-2 apart), 2e-2 relative L2 of
every new BatchNorm statistic.

* ``DiffUNet``, ``DiffUNet1`` and ``Nocon`` against JAX's
  ``dual_train_forward``, and ``DiffUNet1`` against JAX's module path too
  (the dual chain sums its 1x1 products in f32 before one rounding, where
  the modules round each conv);
* a loss on its output sends gradients to both branches' canonical
  parameters, which agree with the module path's within bf16 noise.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from prior_diffuse_tpu.models.fused_forward import dual_train_forward as jax_dual
from prior_diffuse_tpu_torch.convert import flax_to_state_dict
from prior_diffuse_tpu_torch.models.fused_forward import dual_train_forward
from prior_diffuse_tpu_torch.models.precision import compute_view
from test_torch_bf16_train import (BF16, FORWARD_RMS, UNETS, _stats_close, f32, make_model,
                                   rel_l2, rel_rms)

torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.mark.parametrize("name", UNETS)
def test_dual_train_forward_matches_flax(name):
    """The port's dual train forward against JAX's ``dual_train_forward``
    and JAX's module path (the dual chain sums its 1x1 products in f32
    before one rounding where the modules round each conv), outputs and
    the new statistics of every BatchNorm, the two branches' included."""
    _, jm, _, variables, tm, args = (name, *make_model(name))
    jargs = [jnp.asarray(a) for a in args]
    names = {"DiffUNet1": ("x_init", "t"), "Nocon": ("t",)}.get(name, ())
    kw = dict(zip(names, jargs[1:]))
    y, new = jax.jit(lambda v: jax_dual(v, jargs[0], dtype=BF16, **kw))(variables)
    view = compute_view(tm, torch.bfloat16).train()
    targs = [torch.from_numpy(a) for a in args]
    got = dual_train_forward(view, targs[0], dtype=torch.bfloat16, **dict(zip(names, targs[1:])))
    assert got.dtype == torch.bfloat16
    assert rel_rms(got.detach().float().numpy(), f32(y)) <= FORWARD_RMS
    if name == "DiffUNet1":
        y_mod, _ = jax.jit(lambda v, *a: jm.apply(v, *a, train=True,
                                                  mutable=["batch_stats"]))(variables, *jargs)
        assert rel_rms(got.detach().float().numpy(), f32(y_mod)) <= FORWARD_RMS
    _stats_close(tm, new)


def test_dual_train_forward_gradients_reach_the_branch_parameters():
    """The dual decoder is packed inside the forward: a loss on its output
    sends gradients to both branches' canonical parameters (and BN scales),
    and they agree with the module path's within bf16 noise."""
    _, _, _, variables, tm, args = ("DiffUNet1", *make_model("DiffUNet1"))
    targs = [torch.from_numpy(a) for a in args]
    view = compute_view(tm, torch.bfloat16).train()
    grads = []
    for fused in (True, False):
        tm.load_state_dict(flax_to_state_dict(tm, variables))
        tm.zero_grad(set_to_none=True)
        out = (dual_train_forward(view, *targs) if fused else view(*targs)).float()
        (out ** 2).mean().backward()
        grads.append({n: p.grad for n, p in tm.named_parameters()})
    for n in ("core.de_real.de3.l.weight", "core.de_imag.de3.r.weight",
              "core.de_real.bn4.weight", "core.de_imag.prelu2.weight",
              "core.de_real.de1.tp.weight", "core.en.conv2.l.weight"):
        assert grads[0][n] is not None and grads[0][n].dtype == torch.float32, n
        assert rel_l2(grads[0][n].numpy(), grads[1][n].numpy()) <= 0.2, n
