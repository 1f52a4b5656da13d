"""One bf16 train step of the port's ComplexTrainer (GCRN,
``aia_complex_trans_ri``) and MagTrainer (GRN) against the JAX trainers'
(CPU), then evaluation and ``enhance_batch`` on JAX's new state.

As ``test_torch_bf16_train_step.py`` (its helpers; batch 2 x 1600
samples): ``train.compute_dtype: bfloat16``, the prior's bf16-compute
module forward on its f32 parameters, its estimate cast to f32 before the
loss (JAX ``complex_trainer.py:98-104``, ``mag_trainer.py``), one JAX
compile a family, in a module-scoped fixture.  Each step is held to twice
the largest of JAX's own three spread samples (its op-by-op step, and its
jitted step on the batch times ``1 + 1e-7 N(0, 1)``, two seeds, against
the jitted step; ``BOUNDS``, from ``python3 tools/bf16_train_probe.py step
complex-GCRN complex-aia_complex_trans_ri mag-GRN``, on the CPU; ROADMAP
Queue 3).  JAX's largest sample / the port, GCRN: losses 4.0e-5 / 4.5e-5,
statistics 2.2e-5 / 2.3e-5, gradient 2.2e-2 / 2.2e-2, updates 4.2e-3 /
4.3e-3; ``aia_complex_trans_ri``: 7.2e-5 / 4.0e-5, gradient 8.0e-2 /
8.1e-2, updates 5.3e-3 / 6.0e-3; GRN: losses 7.8e-4 / 4.3e-4, statistics
2.1e-3 / 3.7e-3, gradient 4.0e-2 / 6.9e-2, updates 5.1e-3 / 8.4e-4.
GRN's port sits ~2x further than those samples: it first leaves JAX's
forward at ``dila2``, where it sums the conv's float32 products in
another order (``python3 tools/grn_front_probe.py forward --ops``;
``test_torch_bf16_grn_front.py``), which neither sample varies; JAX's own
step with only the front end's summation order changed (its channels
permuted) sits further still, gradient 8.0e-2, statistics 4.0e-3, flips
1.3e-2 (``tools/grn_front_probe.py step``; ROADMAP Queue 3).

Evaluation (JAX's ``_eval_step``: the estimate in the prior's own dtype,
bf16 for GCRN and the RI variant, f32 for GRN, which casts back) within
the eval forward's bound of ``test_torch_bf16_train.py`` (2e-2; 3e-2 for
``aia_complex_trans_ri``).  ``enhance_batch``: JAX's ``ComplexTrainer``
decompresses the bf16 estimate in bf16 and runs its ISTFT's product on
bf16 DFT matrices (``signal/stft.py:213-228``; the window then promotes
the frames to f32); the port casts the estimate to f32 and runs K2
(float32 only).  Its waveform is held to JAX's within the estimate's
bound plus JAX's own distance between its bf16 and f32 ISTFT of the same
estimate, which the test measures (ROADMAP Queue 3).  ``MagTrainer``'s
estimate meets the f32 phase, so its ISTFT is f32 in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu_torch.convert import flax_to_state_dict
from test_torch_bf16_train_step import BOUNDS, check_step, rel_rms, step_pair, torch_batch
from test_torch_train_step import _np

torch.set_num_threads(min(2, torch.get_num_threads()))

CASES = ("complex-GCRN", "complex-aia_complex_trans_ri", "mag-GRN")
EST_RMS = {"complex-GCRN": 2e-2, "complex-aia_complex_trans_ri": 3e-2, "mag-GRN": 2e-2}


@pytest.fixture(scope="module", params=CASES)
def pair(request, tmp_path_factory):
    out = step_pair(request.param, tmp_path_factory.mktemp(request.param))
    tr, jtr = out["tr"], out["jtr"]
    tr.model.load_state_dict(flax_to_state_dict(tr.model, _np(jtr.state["model"]),
                                                batches_tracked=1))
    return out


def test_step_matches_jax_within_its_own_spread(pair):
    check_step(pair, BOUNDS[pair["case"]])
    tr = pair["tr"]
    assert tr.compute_dtype == torch.bfloat16 and tr.model_train is not tr.model
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    assert tr.opt.state and all(s["exp_avg"].dtype == torch.float32
                                for s in tr.opt.state.values())


def test_eval_step_matches_jax(pair):
    jtr, tr, batch = pair["jtr"], pair["tr"], pair["batch"]
    est, label, loss = jtr._eval_step(jtr.state, *jtr.put_batch(
        batch.noisy, batch.clean, batch.frame_nums))
    g_est, g_label, g_loss = tr._eval_step(*torch_batch(batch))
    assert str(g_est.dtype).split(".")[-1] == str(est.dtype)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    assert rel_rms(g_est.float().numpy(), f32(est)) <= EST_RMS[pair["case"]]
    assert np.abs(g_label.numpy() - f32(label)).max() <= 2.5e-4 * np.abs(f32(label)).max()
    assert abs(float(g_loss) - float(loss)) <= EST_RMS[pair["case"]] * abs(float(loss))


def test_enhance_batch_matches_jax(pair):
    from prior_diffuse_tpu.signal.compress import decompress_spec
    from prior_diffuse_tpu.signal.stft import istft
    from prior_diffuse_tpu.training.base import spec_features

    jtr, tr, batch = pair["jtr"], pair["tr"], pair["batch"]
    wav = batch.noisy
    want = np.asarray(jtr.enhance_batch(wav, jax.random.PRNGKey(0)))
    got = tr.enhance_batch(torch.from_numpy(wav)).numpy()
    assert got.dtype == np.float32 and got.shape == wav.shape
    slack = 0.0
    if pair["case"].startswith("complex"):
        # JAX's own bf16 ISTFT of its estimate against its f32 ISTFT of it
        est = jtr._apply(jtr.state["model"], spec_features(jnp.asarray(wav), jtr.cfg),
                         train=False)[0]
        assert est.dtype == jnp.bfloat16
        as_f32 = istft(decompress_spec(est.astype(jnp.float32), jtr.cfg.feat_type),
                       length=wav.shape[-1])
        slack = rel_rms(want, np.asarray(as_f32))
        assert 0 < slack < 5e-2
    assert rel_rms(got, want) <= EST_RMS[pair["case"]] + slack
