"""One bf16 train step of the port's ComplexDDPMTrainer with a GCRN prior
against the JAX trainer's (CPU), then ``enhance_batch`` on JAX's new state.

As ``test_torch_bf16_train_step.py`` (its helpers; batch 2 x 1600 samples,
pirorgrad, ``--joint --sigma``), with ``model.name: GCRN``: in bf16 the
prior trains through its module forward in bf16 compute (GCRN's grouped
LSTM in f32 on its unrounded weights) and the ``DiffUNet1`` denoiser
through the dual train forward (JAX ``_dis_apply`` / ``_ddpm_apply``,
``ddpm_trainer.py:249-268``).  The step is held to twice the largest of
JAX's own three spread samples (its op-by-op step, and its jitted step on
the batch times ``1 + 1e-7 N(0, 1)``, two seeds; ``BOUNDS``, from
``python3 tools/bf16_train_probe.py step ddpm-GCRN``, on the CPU; ROADMAP
Queue 3): JAX's largest / the port's, losses 1.1e-4 / 7.3e-5, statistics
1.1e-3 / 1.1e-3, gradient 8.7e-2 / 9.2e-2, updates 1.2e-2 / 1.2e-2.

``enhance_batch`` (JAX's serving of a bf16-trained model, ``serve_dtype``
float32: the bf16-compute modules with two decoders, ``x_init`` cast to
f32, the chain in f32 from the same ``x_T``, K1 and K2) within 2e-2
relative RMS of JAX's waveform.
"""

import jax
import numpy as np
import pytest
import torch

from prior_diffuse_tpu_torch.convert import flax_to_state_dict
from prior_diffuse_tpu_torch.serving.enhancer import ComputeEnhancer
from test_torch_bf16_train_step import BOUNDS, check_step, nets_of, rel_rms, step_pair
from test_torch_train_step import _np

torch.set_num_threads(min(2, torch.get_num_threads()))

CASE = "ddpm-GCRN"


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return step_pair(CASE, tmp_path_factory.mktemp("ddpm_gcrn"))


def test_step_matches_jax_within_its_own_spread(pair):
    check_step(pair, BOUNDS[CASE])
    tr = pair["tr"]
    assert tr.fused_train and not hasattr(tr.dis_train, "core")  # GCRN: the module path


def test_enhance_batch_matches_jax(pair):
    jtr, tr, batch = pair["jtr"], pair["tr"], pair["batch"]
    for name in nets_of(CASE):  # JAX's state after its step
        tr.nets[name].load_state_dict(flax_to_state_dict(
            tr.nets[name], _np(jtr.state[name]), batches_tracked=1))
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jtr.enhance_batch(batch.noisy, rng))
    shape = (2, batch.noisy.shape[1] // 160 + 1, 161, 2)
    x_T = np.array(jax.random.normal(jax.random.split(rng)[0], shape))[None]
    assert isinstance(tr.enhancer, ComputeEnhancer)
    got = tr.enhancer.enhance_batch(torch.from_numpy(batch.noisy),
                                    x_T=torch.from_numpy(x_T)).numpy()
    assert want.dtype == np.float32 and got.dtype == np.float32
    assert rel_rms(got, want) <= 2e-2
