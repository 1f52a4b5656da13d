"""The joint train step, driven step after step.

Set-up builds one ``ComplexDDPMTrainer`` (``--joint --sigma``) with the
configuration's optimizers, loads weights drawn from the seed, and makes
``batches`` distinct batches of ``rows`` x ``length`` noisy/clean pairs
and their q-sample draws on the device.  Every step, those of set-up and
those of the window alike, is ``_train_step(noisy, clean, frame_nums,
draws=..., norms=step % norms_every == 0)`` followed by the loss's scalar
read-back, as the training loop does.  The first three steps run in
set-up, on three batches whose rows all differ; the check compares their
losses, the first step's gradients as Adam took them and each
parameter's change over the three with the reference, which follows them
from the same weights, batches and draws.  After the window one more step
goes through the same call, on the path as the window left it; the
reference follows that step from the program's state before it (its
weights and Adam's moments), and the check compares its loss, its
gradients as Adam took them and its change.

The trainer needs a data root: set-up writes one pair of wavs of
``length`` samples for each split under a directory of ``TMPDIR``, which
the steps never read.

Mix keys: ``rows``, ``length``, ``batches``, ``norms_every``, ``snr_db``,
``trace_seconds``.
"""

from __future__ import annotations

import copy
import os
import shutil
import tempfile
import wave
from time import perf_counter

import numpy as np
import torch

from benchmark.count.flops import flops_of
from benchmark.harness.core import Reading
from benchmark.harness.inputs import generator, noisy_speech, seeded_state
from benchmark.reference import models as ref, precision as rp, train as rtrain

CHECKED_STEPS = 3
BETA1 = 0.9


def write_wav(path: str, samples: int) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.zeros(samples, np.int16).tobytes())


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def norm_gaps(got: dict, want: dict, keys) -> np.ndarray:
    """Each leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    median = float(np.median([want[k] for k in keys]))
    return np.array([abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in keys])


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cell.config
        self.traffic = ctx.cell.traffic
        self.attempted = self.failed = 0
        self.mutate = None
        self.trainer = None
        self.steps = 0
        self.window_steps = 0
        self.late = None

    # ---- set-up ------------------------------------------------------------
    def setup(self):
        from prior_diffuse_tpu_torch.config import RunConfig, experiment_from_dict
        from prior_diffuse_tpu_torch.diffusion.qsample import Draws
        from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

        t, dev, seed = self.traffic, self.ctx.device, self.ctx.seed
        raw = copy.deepcopy(self.cfg["experiment"])
        raw["train"].update(batch_size=t["rows"], chunk_length=t["length"])
        self.raw = raw
        exp = experiment_from_dict(raw)
        self.tmp = tempfile.mkdtemp(prefix="benchmark-train-")
        data = os.path.join(self.tmp, "data")
        for kind in ("noisy", "clean"):
            for split in ("trainset", "testset"):
                write_wav(os.path.join(data, f"{kind}_{split}_wav", "u0.wav"), t["length"])
        run = RunConfig(seed=seed % 2 ** 31, joint=self.cfg["training"]["joint"],
                        sigma=self.cfg["training"]["sigma"], data_root=data,
                        assets=os.path.join(self.tmp, "assets"))
        tr = ComplexDDPMTrainer(run, exp, device=dev)
        self.state = {"dis": seeded_state(ref.DiffUNet(), seed, dev, 1),
                      "ddpm": seeded_state(ref.DiffUNet1(exp.diffusion.num_steps), seed, dev, 2)}
        tr.dis.load_state_dict(self.state["dis"])
        tr.ddpm.load_state_dict(self.state["ddpm"])
        self.trainer = tr
        self.ctx.mark("build")
        if self.mutate is not None:
            self.mutate(self)

        g = generator(seed, dev, 5)
        frames = t["length"] // 160 + 1
        self.batches, self.draws = [], []
        for _ in range(t["batches"]):
            noisy, clean = noisy_speech(t["rows"], t["length"], g, dev, t["snr_db"])
            fn = torch.full((t["rows"],), frames, dtype=torch.int64, device=dev)
            self.batches.append((noisy, clean, fn))
            idx = torch.randint(0, exp.diffusion.num_steps, (t["rows"],), generator=g, device=dev)
            normal = torch.randn((t["rows"], frames, 161, 2), generator=g, device=dev)
            self.draws.append((idx, normal))
        self._draws = [Draws(i, n) for i, n in self.draws]
        self.ctx.mark("inputs")

        self.losses = [self.step() for _ in range(CHECKED_STEPS)]
        self.grad_norms, self.change_norms = self.snapshot()
        self.ctx.mark("checked steps")

    def moments(self) -> dict:
        """Each leaf's Adam moments ``(m, v)`` as they stand (zeros for a
        leaf Adam never stepped)."""
        out = {}
        for name, p, opt in self.named():
            st = opt.state.get(p, {})
            out[name] = tuple(st.get(k, torch.zeros_like(p)).detach().clone()
                              for k in ("exp_avg", "exp_avg_sq"))
        return out

    def named(self):
        tr = self.trainer
        return [(f"dis.{n}", p, tr.opt_dis) for n, p in tr.dis.named_parameters()] + [
            (f"ddpm.{n}", p, tr.opt_ddpm) for n, p in tr.ddpm.named_parameters()]

    def snapshot(self):
        """After the checked steps: each leaf's first gradient as Adam took
        it, from Adam's first moment after step one (``(1 - beta1) g``),
        and each leaf's change over the checked steps."""
        grads, changes = {}, {}
        init = {f"{net}.{k}": v for net, sd in self.state.items() for k, v in sd.items()}
        for name, p, opt in self.named():
            changes[name] = p.detach() - init[name]
            grads[name] = self.first_moments[name] / (1 - BETA1)
        return leaf_norms(grads), leaf_norms(changes)

    def step(self):
        t = self.traffic
        k = self.steps
        b = self.batches[k % len(self.batches)]
        out = self.trainer._train_step(*b, draws=self._draws[k % len(self._draws)],
                                       norms=k % t["norms_every"] == 0)
        loss = float(out[0])
        if k == 0:  # a leaf Adam never stepped took no gradient
            self.first_moments = {name: m for name, (m, _) in self.moments().items()}
        self.steps += 1
        return loss

    def after_window(self):
        """One more step through the window's call, after its last: the
        program's weights and moments before it, its loss, each leaf's
        gradient as Adam took it (``(m' - beta1 m) / (1 - beta1)``) and
        each leaf's change."""
        params = {name: p.detach().clone() for name, p, _ in self.named()}
        moments = self.moments()
        k = self.steps
        loss = self.step()
        after = self.moments()
        grads = {n: (after[n][0].double() - BETA1 * moments[n][0].double()) / (1 - BETA1)
                 for n in after}
        changes = {name: p.detach() - params[name] for name, p, _ in self.named()}
        self.late = {"step": k, "params": params, "moments": moments, "loss": loss,
                     "grads": leaf_norms(grads), "changes": leaf_norms(changes)}

    # ---- the window -----------------------------------------------------------
    def window(self, seconds, spans):
        if spans is not None:
            spans.wrap(self.trainer, "_train_step", "trainer.train_step")
        t0 = perf_counter()
        while True:
            self.step()
            self.window_steps += 1
            self.attempted += 1
            if perf_counter() - t0 >= seconds:
                break

    def end_to_end(self, window_s: float) -> dict:
        return {"train_utt_per_s": (self.traffic["rows"] * self.window_steps / window_s,
                                    "utt/s")}

    def trace_counts(self) -> dict:
        return {"steps": self.window_steps,
                "model_flops": self.window_steps * self.step_flops()}

    def step_flops(self) -> float:
        """Model FLOPs of the reference step's forward and backward at the
        step's shape, counted on the meta device."""
        t = self.traffic
        prior = ref.DiffUNet().to("meta")
        ddpm = ref.DiffUNet1(len(self.raw["diffusion"]["noise_schedule"])).to("meta")
        rows, frames = t["rows"], t["length"] // 160 + 1
        meta = lambda *s, **kw: torch.empty(s, device="meta", **kw)  # noqa: E731
        alpha_bar = meta(len(self.raw["diffusion"]["noise_schedule"]))

        def step():
            loss = rtrain.step_loss(
                prior, ddpm, meta(rows, t["length"]), meta(rows, t["length"]),
                meta(rows, dtype=torch.int64), meta(rows, dtype=torch.int64),
                meta(rows, frames, 161, 2), alpha_bar, 11.0, 1.0)
            loss.backward()
        return flops_of(step)

    def release(self):
        self.trainer = None
        self.first_moments = None
        shutil.rmtree(self.tmp, ignore_errors=True)

    # ---- the check ----------------------------------------------------------
    def reference_nets(self, params=None):
        dev = self.ctx.device
        prior, ddpm = ref.DiffUNet(), ref.DiffUNet1(len(self.raw["diffusion"]["noise_schedule"]))
        for net, key in ((prior, "dis"), (ddpm, "ddpm")):
            sd = dict(self.state[key])
            if params is not None:
                sd.update({n[len(key) + 1:]: v for n, v in params.items()
                           if n.startswith(key + ".")})
            net.load_state_dict(sd)
        return prior.to(dev), ddpm.to(dev)

    @staticmethod
    def changes_of(prior, ddpm, start: dict) -> dict:
        out = {f"dis.{n}": p.detach() - start[f"dis.{n}"] for n, p in prior.named_parameters()}
        out.update({f"ddpm.{n}": p.detach() - start[f"ddpm.{n}"]
                    for n, p in ddpm.named_parameters()})
        return leaf_norms(out)

    def reference(self, precision: str) -> dict:
        """The reference's readings in ``precision``: the checked steps
        from the seeded weights, and the step after the window from the
        program's state before it."""
        init = {f"{net}.{k}": v for net, sd in self.state.items() for k, v in sd.items()}
        prior, ddpm = self.reference_nets()
        with rp.computed_in(precision):
            losses, grads = rtrain.train(prior, ddpm, self.batches, self.draws, self.raw,
                                         CHECKED_STEPS)
        out = {"losses": losses, "grads": leaf_norms(grads),
               "changes": self.changes_of(prior, ddpm, init)}
        late = self.late
        if late is not None:
            k = late["step"] % len(self.batches)
            prior, ddpm = self.reference_nets(late["params"])
            with rp.computed_in(precision):
                l_losses, l_grads = rtrain.train(prior, ddpm, [self.batches[k]], [self.draws[k]],
                                                 self.raw, 1, late["moments"], late["step"])
            out.update(late_losses=l_losses, late_grads=leaf_norms(l_grads),
                       late_changes=self.changes_of(prior, ddpm, late["params"]))
        return out

    def program(self) -> dict:
        out = {"losses": self.losses, "grads": self.grad_norms, "changes": self.change_norms}
        late = self.late
        if late is not None:
            out.update(late_losses=[late["loss"]], late_grads=late["grads"],
                       late_changes=late["changes"])
        return out

    def readings(self, got: dict, want: dict) -> list:
        """For the checked steps (``*``) and the step after the window
        (``late_*``): the loss gap of the worst step, and the median leaf's
        gap of gradient norms and of change norms (leaves whose reference
        gradient is under a thousandth of the median leaf's left out of
        the change), and the 90th-percentile leaf's where the cell gives it
        a limit (``*_p90``).  The 90th percentile and the worst leaf of
        each gap are kept in ``self.detail``: the worst is not compared, a
        PReLU slope's gradient being one sum over a whole activation that
        cancels to a few parts in a thousand, so that its float32 rounding
        alone moves it by percents (PERF.md)."""
        lim = self.ctx.cell.limits
        out, self.detail = [], {}
        for pre in ("", "late_"):
            if pre + "losses" not in got:
                continue
            loss = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(got[pre + "losses"], want[pre + "losses"]))
            g_want = want[pre + "grads"]
            keys = sorted(g_want)
            floor = 1e-3 * float(np.median([g_want[k] for k in keys]))
            moving = [k for k in keys if g_want[k] >= floor]
            gaps = {"grad_gap": (norm_gaps(got[pre + "grads"], g_want, keys), keys),
                    "change_gap": (norm_gaps(got[pre + "changes"], want[pre + "changes"],
                                             moving), moving)}
            out.append(Reading(pre + "loss_gap", loss, lim[pre + "loss_gap"]))
            for name, (gap, names) in gaps.items():
                p90 = float(np.quantile(gap, 0.9))
                out.append(Reading(pre + name, float(np.median(gap)), lim[pre + name]))
                if pre + name + "_p90" in lim:
                    out.append(Reading(pre + name + "_p90", p90, lim[pre + name + "_p90"]))
                self.detail.update({
                    f"{pre}{name}_p90": p90, f"{pre}{name}_worst": float(gap.max()),
                    f"{pre}{name}_worst_leaf": names[int(gap.argmax())]})
            self.detail[pre + "change_leaves_left_out"] = len(keys) - len(moving)
        return out

    def check(self) -> list:
        return self.readings(self.program(), self.reference("float32"))

    def control(self, precision: str) -> dict:
        """The control's readings: the reference in ``precision`` in the
        program's place, against the reference in float32 (its 90th
        percentiles and worst leaves under ``detail``)."""
        values = {r.name: r.value for r in self.readings(self.reference(precision),
                                                         self.reference("float32"))}
        return dict(values, detail=self.detail)
