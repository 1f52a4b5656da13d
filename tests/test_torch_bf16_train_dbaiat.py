"""The bf16-compute forward of bf16 training of the four DB-AIAT variants
against flax's (CPU).

As ``test_torch_bf16_train.py`` (the same variables, inputs and helpers;
B = 2, T = 12), for ``aia_complex_trans_ri`` (``conf/dbaiat.yml``),
``aia_complex_trans_mag``, ``dual_aia_complex_trans`` and
``dual_aia_trans_merge_crm``.  They have no BatchNorm, so their train and
eval forwards are one function; the policy is the trace's (``python3
tools/bf16_trace.py --train``): the convs, the attention and ``linear2``
in bf16 (``linear2`` computes in f32 in the bf16 *serving* copy), the GRUs,
the LayerNorms (which return f32) and AHAM's conv in f32.

Bounds, relative RMS against JAX's jitted forward: 2e-2 for
``aia_complex_trans_mag``, 3e-2 for the three variants with an RI branch,
whose bf16 forward is chaotic (ROADMAP Queue 3, as in bf16 serving).
JAX's own jitted and op-by-op forwards sit 1.7e-2 (``_ri``), 2.5e-3
(``_mag``), 2.4e-2 (``dual_aia_complex_trans``) and 1.5e-2
(``dual_aia_trans_merge_crm``) apart and the port 1.7e-2, 2.5e-3, 2.5e-2
and 1.5e-2 from the jitted one (``python3 tools/bf16_train_probe.py
forward``, on the CPU).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from prior_diffuse_tpu_torch.models.precision import compute_view
from test_torch_bf16_train import f32, make_model, rel_rms

torch.set_num_threads(min(2, torch.get_num_threads()))

RMS = {"aia_complex_trans_ri": 3e-2, "aia_complex_trans_mag": 2e-2,
       "dual_aia_complex_trans": 3e-2, "dual_aia_trans_merge_crm": 3e-2}


@pytest.mark.parametrize("name", list(RMS))
def test_forward_matches_flax(name):
    jm, _, variables, tm, args = make_model(name)
    y = jax.jit(lambda v, x: jm.apply(v, x, train=True))(variables, jnp.asarray(args[0]))
    with torch.no_grad():
        got = compute_view(tm, torch.bfloat16).train()(torch.from_numpy(args[0]))
    assert str(got.dtype).split(".")[-1] == str(y.dtype)  # bf16, f32 where JAX casts back
    assert rel_rms(got.float().numpy(), f32(y)) <= RMS[name]
    assert all(p.dtype == torch.float32 for p in tm.parameters())
