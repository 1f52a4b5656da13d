"""``chip_smoke.py``'s phases 8-10 (the priors, GRN and DiffWave, bf16
training) rehearsed on the CPU, as ``test_torch_chip_smoke.py`` rehearses
phases 3-7 and 12: the same stand-ins for the kernels (their plain
versions, counting launches; K1 on its table's window), the real launch
counts and bounds, each phase's seconds under the four kinds.

The size is batch 2 x 3200 samples: at 1600 the bf16 step sits 1.1e-3
(losses) from the f32 step on the same weights and draws, past phase 10's
1e-3 for the card's 6 x 48000; at 3200 it reads 2.0e-4.  GCRN stands for
the complex priors (DB-AIAT runs the same code, at ~5x the CPU time); the
card-vs-CPU comparisons compare two CPU runs here (bit-equal), at 2 x 3200,
but for the bf16 enhancer's, which names the card's run by its device
type: its call is recorded.
"""

from unittest import mock

import pytest
import torch

import chip_smoke as cs
from test_torch_chip_smoke import CPU, rehearsal, run_phase

torch.set_num_threads(min(2, torch.get_num_threads()))

LENGTH = 3200
STEP = {"stft": 2, "istft": 0, "enc_stage": 0}
SERVE = {"stft": 1, "istft": 1, "enc_stage": 0, "enc_stage_bf16": 0}


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("chip_smoke_priors"))
    with rehearsal(root, LENGTH):
        mp = pytest.MonkeyPatch()
        mp.setattr(cs, "CARD_VS_CPU_LENGTH", LENGTH)
        mp.setattr(cs, "BF16_PRIORS", ("GCRN",))
        mp.setattr(cs, "BF16_TRAIN_PRIORS", ("GCRN", "GRN"))
        try:
            priors = cs.prior_nets(CPU)
            yield {"root": root, "corpus": cs.write_train_corpus(root),
                   "ddpm": cs.seeded_nets(0, CPU)[1], "gcrn": priors["GCRN"],
                   "grn": cs.grn_net(CPU)}
        finally:
            mp.undo()


def test_phase8_gcrn(smoke):
    root, corpus, net = smoke["root"], smoke["corpus"], smoke["gcrn"]
    tr = cs.complex_trainer(CPU, "GCRN", net, root, corpus)
    counts, _ = run_phase("8", cs.complex_serving, CPU, "GCRN", tr)
    assert counts == SERVE
    paths, row = run_phase("8", cs.prior_ddpm_phase, CPU, "cpu", root, corpus, "GCRN", net,
                           smoke["ddpm"])
    k3 = {**SERVE, "enc_stage": 30}
    assert paths == {"serve_batch_GCRN": k3, "serve_batch_GCRN_sigma": k3,
                     "prior_only_GCRN": SERVE, "train_step_ddpm_GCRN": {**STEP,
                                                                       "enc_stage_bf16": 0},
                     "evaluate_cv_batch_ddpm_GCRN": {"stft": 2, "istft": 2, "enc_stage": 30,
                                                     "enc_stage_bf16": 0}}
    assert row["setup"] > 0
    paths, row = run_phase("8", cs.complex_train_phase, CPU, "cpu", root, corpus, "GCRN", net)
    assert paths == {"train_step_complex_GCRN": STEP,
                     "evaluate_cv_batch_complex_GCRN": {"stft": 2, "istft": 2, "enc_stage": 0,
                                                        "enc_stage_bf16": 0}}
    assert row["setup"] > 0 and row["measure"] == 0


def test_phase9_grn_diffwave_bf16_priors(smoke):
    paths, row = run_phase("9", cs.grn_phase, CPU, "cpu", smoke["root"], smoke["corpus"],
                           smoke["grn"])
    assert paths["serve_batch_mag_GRN"] == SERVE
    assert paths["train_step_mag_GRN"] == STEP
    # the ragged cv batch: 4 test utterances in batches of 2 and 2
    assert paths["evaluate_cv_batch_mag_GRN"] == {**SERVE, "stft": 4, "istft": 4}
    assert row["setup"] > 0 and row["measure"] == 0
    run_phase("9", cs.diffwave_phase, CPU)
    # the bf16 enhancer on the card against the CPU needs a card: recorded
    calls = []
    with mock.patch.object(cs, "bf16_card_vs_cpu", lambda *a: calls.append(a[2:])):
        paths, _ = run_phase("9", cs.bf16_prior_phase, CPU, {"GCRN": smoke["gcrn"]},
                             smoke["ddpm"])
    assert calls == [({"pirorgrad": smoke["ddpm"]}, cs.BF16_PRIOR_CARD_VS_CPU_RMS["GCRN"],
                      "GCRN prior, ")]
    k3 = {**SERVE, "enc_stage_bf16": 30}
    assert paths == {"prior_only_GCRN_bf16": SERVE, "serve_batch_GCRN_bf16": k3,
                     "serve_batch_GCRN_bf16_sigma": k3}


def test_phase10_bf16_training(smoke):
    paths, row = run_phase("10", cs.bf16_train_phase, CPU, "cpu", smoke["root"],
                           smoke["corpus"], {"GCRN": smoke["gcrn"], "GRN": smoke["grn"]})
    cv = {**SERVE, "stft": 2, "istft": 2}
    assert paths == {"train_step_bf16": STEP, "evaluate_cv_batch_bf16": cv,
                     "cli_train_bf16": {**SERVE, "stft": 6, "istft": 2},
                     "cli_generate_bf16": SERVE,
                     "train_step_bf16_complex_GCRN": STEP, "serve_batch_bf16_complex_GCRN": SERVE,
                     "train_step_bf16_mag_GRN": STEP, "serve_batch_bf16_mag_GRN": SERVE}
    assert row["setup"] > 0 and row["measure"] == 0
