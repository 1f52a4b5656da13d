"""``chip_smoke.py``'s phases rehearsed on the CPU, and its accounting.

* :class:`chip_smoke.Accounts` books each second of a run to the phase
  last named and to the innermost ``spent`` block's kind (``check``
  outside any); a kind outside the four is refused; ``device_us`` sums
  the device events of a profile's kineto events (user annotations left
  out);
* ``tools/card_numbers.py``, which prints the times no check reads,
  refuses to run without a CUDA card, as ``chip_smoke.py`` does;
* phases 3, 4, 5, 7 and 12 (``test_torch_chip_smoke_priors.py``: 8-10) run
  at a tiny size (batch 2 x 1600 samples, a corpus of 4 + 2 short
  utterances, ymls cut to match) with every kernel wrapper replaced by a
  stand-in on the CPU: its plain version, counting its launches as the
  kernel does, K1 on the window of its own table (so the train-step
  checks' wrong-window controls must miss, as on the card).  The real
  ``expect_counts`` and ``fail`` hold each phase to the card's launch
  counts and bounds; ``cuda_ms``, ``graph_ms``, ``device_ms`` and
  ``top_kernels`` run their function once and return a stand-in number,
  booked as measurement.  Each phase's seconds land under the four kinds
  and add up to its wall time;
* phase 12's ranks are processes of their own without the stand-ins, so
  its launch counts cannot hold here: the test holds its restructured
  parts (the ranks' inputs, their spawning, the untimed runs) instead;
  phase 11's command lines need a card (its trace counts K1's records),
  so it is held to what changed: its command lines and phase 12's ranks
  and command line run beside the phase's other work, and a check that
  fails stops every process the phase started.
"""

import os
import re
import subprocess
import sys
import time
from contextlib import contextmanager
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke as cs
from prior_diffuse_tpu_torch import cli
from prior_diffuse_tpu_torch.models.diffunet import Nocon
from prior_diffuse_tpu_torch.ops.cuda import convblock as cb
from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
from prior_diffuse_tpu_torch.signal import stft as sigstft

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


class Failed(Exception):
    """A ``chip_smoke.fail`` raised in a rehearsal."""


def _fail(msg):
    raise Failed(msg)


def _counted(fn):
    fn.launches = 0
    return fn


@_counted
def _k1(x):
    """K1's stand-in: the plain STFT on the window of K1's own table."""
    window = kstft._device_operands(x.device)[0][:320].cpu().numpy()
    with mock.patch.object(sigstft, "hann_window",
                           lambda n, dtype=np.float32: window.astype(dtype)):
        out = kstft.stft_plain(x)
    _k1.launches += 1
    return out


@_counted
def _k2(spec, length):
    _k2.launches += 1
    return kstft.istft_plain(spec, length=length)


@_counted
def _k3(*args):
    _k3.launches += 1
    return cb.enc_stage_plain(*args)


@_counted
def _k3_bf16(*args):
    _k3_bf16.launches += 1
    return cb.enc_stage_bf16_plain(*args)


def _once(value):
    """A timing function's stand-in: ``fn`` once, then ``value``."""
    return cs.booked("measure")(lambda fn, *a, **k: (fn(), value)[1])


@contextmanager
def rehearsal(root, length: int, batch: int = 2):
    """``chip_smoke`` at ``batch`` x ``length`` samples on the CPU (module
    docstring); ``root`` gets the cut ymls and a link to the package."""
    os.makedirs(os.path.join(root, "conf"), exist_ok=True)
    for name in ("diff", "gcrn", "dbaiat", "grn"):
        with open(os.path.join(ROOT, "conf", f"{name}.yml")) as f:
            text = f.read()
        text = re.sub(r"batch_size: \d+", f"batch_size: {batch}", text)
        text = re.sub(r"chunk_length: \d+", f"chunk_length: {length}", text)
        with open(os.path.join(root, "conf", f"{name}.yml"), "w") as f:
            f.write(text)
    if not os.path.exists(os.path.join(root, "prior_diffuse_tpu_torch")):
        os.symlink(os.path.join(ROOT, "prior_diffuse_tpu_torch"),
                   os.path.join(root, "prior_diffuse_tpu_torch"))
    main = cli.main
    mp = pytest.MonkeyPatch()
    grad = torch.is_grad_enabled()
    try:
        for name, value in {
                "ROOT": root, "fail": _fail, "BATCH": batch, "LENGTH": length,
                "T_FRAMES": length // 160 + 1, "CORPUS": (2 * batch, batch),
                "TRAIN_BATCH": batch, "GRN_TEST": batch + 2, "UTTERANCE_LEN": (4800, 8000),
                "LONG_SECONDS": 1,
                "PRIOR_CONFS": {k: (v[0], batch) for k, v in cs.PRIOR_CONFS.items()},
                "cuda_ms": _once(1.0), "graph_ms": _once(1.0), "device_ms": _once(None),
                "top_kernels": _once(([], 0))}.items():
            mp.setattr(cs, name, value)
        mp.setattr(kstft, "stft", _k1)
        mp.setattr(kstft, "istft", _k2)
        mp.setattr(cb, "enc_stage", _k3)
        mp.setattr(cb, "enc_stage_bf16", _k3_bf16)
        mp.setattr(cli, "main", lambda args: main(list(args) + ["--device", "cpu"]))
        mp.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
        torch.set_grad_enabled(False)  # as chip_smoke.main: inference unless a step asks
        yield
    finally:
        torch.set_grad_enabled(grad)
        mp.undo()


def run_phase(name: str, fn, *args):
    """``fn(*args)`` as phase ``name`` of a fresh :class:`chip_smoke.Accounts`;
    returns its result and the phase's seconds by kind, after checking that
    they are the four kinds and add up to the call's wall time."""
    accounts = cs.Accounts()
    with mock.patch.object(cs, "ACCOUNTS", accounts):
        accounts.phase(name)
        t0 = time.perf_counter()
        out = fn(*args)
        wall = time.perf_counter() - t0
        row = accounts.line()["phase_seconds"][name]
    assert sorted(row) == sorted(cs.KINDS)
    assert abs(sum(row.values()) - wall) < 0.05 + 0.01 * wall, (row, wall)
    assert row["check"] > 0
    return out, row


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """The rehearsal at 2 x 1600 with the seeded nets and the corpus."""
    root = str(tmp_path_factory.mktemp("chip_smoke"))
    with rehearsal(root, 1600):
        nets = cs.seeded_nets(0, CPU)
        yield {"root": root, "nets": nets, "corpus": cs.write_train_corpus(root)}


# ---- the accounting ------------------------------------------------------------


def test_accounts_books_each_second_to_its_phase_and_innermost_kind():
    clock = iter(float(t) for t in range(100))  # each reading of the clock: 1 s later
    with mock.patch.object(cs.time, "perf_counter", lambda: next(clock)):
        a = cs.Accounts()                        # 0
        with a.spent("setup"):                   # 1: check +1 (phase 0-1)
            pass                                 # 2: setup +1
        a.phase("3")                             # 3: check +1
        with a.spent("measure"):                 # 4: check +1 (phase 3)
            with a.spent("subprocess"):          # 5: measure +1
                pass                             # 6: subprocess +1
        a.phase("4")                             # 7: measure +1, 8: check +1
        line = a.line()                          # 9: check +1 (phase 4)
    assert line == {"phase_seconds": {
        "0-1": {"setup": 1.0, "check": 2.0, "measure": 0.0, "subprocess": 0.0},
        "3": {"setup": 0.0, "check": 2.0, "measure": 2.0, "subprocess": 1.0},
        "4": {"setup": 0.0, "check": 1.0, "measure": 0.0, "subprocess": 0.0}},
        "total_s": 9.0}
    with pytest.raises(ValueError, match="kind"):
        with a.spent("timing"):
            pass


def test_booked_functions_land_under_their_kind():
    accounts = cs.Accounts()
    with mock.patch.object(cs, "ACCOUNTS", accounts):
        cs.booked("setup")(time.sleep)(0.05)
        kinds = accounts.line()["phase_seconds"]["0-1"]
    assert kinds["setup"] >= 0.05 and kinds["check"] < 0.05


def test_device_us_sums_device_events_without_annotations():
    from torch.autograd import DeviceType

    def event(device, ns, annotation=False):
        return mock.Mock(device_type=lambda: device, duration_ns=lambda: ns,
                         is_user_annotation=lambda: annotation,
                         is_hidden_event=lambda: False)

    events = [event(DeviceType.CUDA, 1500), event(DeviceType.CPU, 10 ** 6),
              event(DeviceType.CUDA, 2500), event(DeviceType.CUDA, 10 ** 5, annotation=True)]
    prof = mock.Mock()
    prof.profiler.kineto_results.events = lambda: events
    assert cs.device_us(prof) == 4.0
    # a real profile on the CPU: the same fields, and no device event
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as real:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert cs.device_us(real) == 0.0


def test_card_numbers_fails_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "card_numbers.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert "card:" not in proc.stdout
    assert "cuda" in proc.stderr.lower()


# ---- the phases ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_phase3_serving_batch(smoke, dtype):
    counts, row = run_phase("3", cs.run_main_path, CPU, *smoke["nets"], dtype)
    k3 = "enc_stage_bf16" if dtype == torch.bfloat16 else "enc_stage"
    want = {"stft": 1, "istft": 1, "enc_stage": 0, "enc_stage_bf16": 0, k3: 35}
    tag = "_bf16" if dtype == torch.bfloat16 else ""
    assert counts == {f"serve_batch{tag}": want, f"serve_batch{tag}_sigma": want}
    assert row["setup"] > 0 and row["measure"] == 0  # its times are card_numbers'


def test_phase3_plain_reference_that_launches_fails(smoke):
    """The plain reference run must launch nothing: a K1 left in it fails."""
    with mock.patch.object(cs, "plain_versions", lambda: mock.MagicMock()):
        with pytest.raises(Failed, match="plain reference run launched"):
            cs.run_main_path(CPU, *smoke["nets"], torch.float32, sigmas=(False,))


def test_phase4_long_wav(smoke):
    counts, _ = run_phase("4", cs.serve_long, CPU, smoke["nets"], "cpu")
    blocks = 6  # 1 s in segments of 1600 samples, 160 overlap, 2 a block
    assert counts == {
        "enhance_long_bf16": {"stft": blocks, "istft": blocks, "enc_stage": 0,
                              "enc_stage_bf16": 35 * blocks},
        "prior_only_long_bf16": {"stft": blocks, "istft": blocks, "enc_stage": 0,
                                 "enc_stage_bf16": 0}}


def test_phase5_training(smoke):
    (step, cv, rows), row = run_phase("5", cs.train_phase, CPU, "cpu", smoke["root"],
                                      smoke["corpus"])
    assert step == {"stft": 2, "istft": 0, "enc_stage": 0}
    assert cv == {"stft": 2, "istft": 2, "enc_stage": 35}
    # the kernels line's training-slice rows: error and times, no step profile
    assert sorted(rows) == ["enc_stage", "istft", "stft"]
    assert rows["stft"]["shape"] == [2, 1600] and rows["enc_stage"]["max_abs_err"] == 0.0
    assert row["setup"] > 0 and row["measure"] > 0


def test_checked_steps_fail_on_a_missing_launch_or_a_non_finite_loss(smoke):
    tr, batches = _ddpm_trainer(smoke, "steps")
    assert cs.checked_steps(tr, batches) == {"stft": 2, "istft": 0, "enc_stage": 0}
    with mock.patch.object(kstft, "stft", kstft.stft_plain):  # K1 not launched
        with pytest.raises(Failed, match="launch counts in 2 train steps"):
            cs.checked_steps(tr, batches)
    nan = [(noisy * float("nan"), *rest) for noisy, *rest in batches]
    with pytest.raises(Failed, match="non-finite train loss"):
        cs.checked_steps(tr, nan)


def _ddpm_trainer(smoke, tag):
    from prior_diffuse_tpu_torch.config import RunConfig, load_experiment
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

    exp = load_experiment(os.path.join(smoke["root"], "conf", "diff.yml"))
    run = RunConfig(seed=7, joint=True, sigma=True, data_root=smoke["corpus"],
                    assets=os.path.join(smoke["root"], f"assets_{tag}"))
    tr = ComplexDDPMTrainer(run, exp, device=CPU)
    return tr, [tr.put_batch(b.noisy, b.clean, b.frame_nums) for b in tr.tr_loader]


def test_phase7_modes(smoke):
    nocon = cs.seeded_nets(1, CPU, (Nocon,))[0]
    counts, _ = run_phase("7", cs.run_main_path, CPU, smoke["nets"][0], nocon, torch.float32,
                          "deltamu", (False, True))
    want = {"stft": 1, "istft": 1, "enc_stage": 35, "enc_stage_bf16": 0}
    assert counts == {"serve_batch_deltamu": want, "serve_batch_deltamu_sigma": want}
    (step, cv), row = run_phase("7", cs.train_mode_phase, CPU, "cpu", smoke["root"],
                                smoke["corpus"], "conditional")
    assert step == {"stft": 2, "istft": 0, "enc_stage": 0}
    assert cv == {"stft": 2, "istft": 2, "enc_stage": 35, "enc_stage_bf16": 0}
    assert row["setup"] > 0 and row["measure"] == 0


def test_phase12_ranks_untimed(smoke):
    """The one process's run and two gloo ranks (processes of their own)
    with ``timed`` off: no step timing, the ranks' nets alike after each
    step, each rank's loader its rows of the global batch, the ranks'
    evaluation the one process's; with ``timed`` a step's ms too."""
    inp, one = cs.dp_inputs(CPU, smoke["root"], smoke["corpus"], 2, "gloo", None, False)
    assert inp["timed"] is False and inp["rank_devices"] == ["cpu", "cpu"]
    assert [len(a) for a in inp["batch"]] == [2, 2, 2]
    full = {"full": one.put_batch(*inp["batch"])}
    untimed = cs.dp_run(one, full)  # from the state the ranks start from
    assert "ms" not in untimed and cs.dp_run(one, full, timed=True)["ms"] > 0
    accounts = cs.Accounts()
    with mock.patch.object(cs, "ACCOUNTS", accounts), \
            mock.patch.dict(os.environ, {"OMP_NUM_THREADS": "1"}):
        outs, wall = cs.dp_outputs(cs.dp_spawn(inp, smoke["root"]))
        kinds = accounts.line()["phase_seconds"]["0-1"]
    assert kinds["subprocess"] >= 0.9 * wall
    assert all("ms" not in o and o["loader_equal"] for o in outs)
    assert outs[0]["steps"]["full"]["digest"] == outs[1]["steps"]["full"]["digest"]
    assert abs(outs[0]["cv_loss"] - untimed["cv_loss"]) <= cs.DP_EVAL_RTOL * abs(
        untimed["cv_loss"])


def test_phase12_stops_its_processes_when_a_check_fails(tmp_path):
    """12a's ranks and 12b's command line run at once; a check of the
    ranks that fails ends the phase with the command line killed."""
    sleeper = lambda name: cs.run_session(  # noqa: E731
        [sys.executable, "-c", "import time; time.sleep(120)"], str(tmp_path / name))
    ranks = {"group": {"procs": [sleeper("rank0"), sleeper("rank1")]}}
    cli_run = {"proc": sleeper("nccl")}
    with mock.patch.object(cs, "dp_ranks_start", lambda *a, **k: ranks), \
            mock.patch.object(cs, "dp_nccl_cli_start", lambda *a, **k: cli_run), \
            mock.patch.object(cs, "dp_ranks_finish", lambda run: _fail("a rank missed")), \
            mock.patch.object(cs, "fail", _fail):
        t0 = time.perf_counter()
        with pytest.raises(Failed, match="a rank missed"):
            cs.dp_phase(CPU, "cpu", str(tmp_path), str(tmp_path))
    assert time.perf_counter() - t0 < 60
    procs = ranks["group"]["procs"] + [cli_run["proc"]]
    assert all(p.returncode == -9 for p in procs)


def test_phase11_stops_its_processes_when_a_check_fails(tmp_path):
    """Phase 11's two command lines run while it checks the native loader
    and ``--draw``; a check that fails ends the phase with both killed."""
    started, run_session = [], cs.run_session

    def session(cmd, log_path, timeout=cs.DP_TIMEOUT, err_path=None):
        started.append((cmd[2], run_session(
            [sys.executable, "-c", "import time; time.sleep(120)"], log_path, timeout,
            err_path)))
        return started[-1][1]

    root = str(tmp_path)
    os.makedirs(os.path.join(root, "conf"))
    with open(os.path.join(ROOT, "conf", "diff.yml")) as f, \
            open(os.path.join(root, "conf", "diff.yml"), "w") as g:
        g.write(f.read())
    with mock.patch.object(cs, "ROOT", root), mock.patch.object(cs, "run_session", session), \
            mock.patch.object(cs, "tooling_checks", lambda *a: _fail("the trace missed")):
        t0 = time.perf_counter()
        with pytest.raises(Failed, match="the trace missed"):
            cs.tooling_phase(CPU, "cpu", root, root)
    assert time.perf_counter() - t0 < 60
    assert [m for m, _ in started] == ["prior_diffuse_tpu_torch.cli",
                                       "prior_diffuse_tpu_torch.metrics.compare"]
    assert all(p.returncode == -9 for _, p in started)
