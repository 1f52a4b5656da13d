"""What the serving drivers share: the port's ``Enhancer`` built from a
configuration file and seeded weights, warm-up, spans, the FLOP and
encoder-stage counts of the traced window, and the check of enhanced
files against the reference."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.count.flops import flops_of
from benchmark.count.stages import encoder_bound_s
from benchmark.harness.core import Reading
from benchmark.harness.inputs import derived_seed, generator, seeded_state
from benchmark.reference import dsp, models as ref, precision as rp
from benchmark.reference import serve as rserve

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """``||got - want|| / ||want||`` in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


class ServingDriver:
    """Subclasses set ``self.calls`` (what the window served, for the
    check) and implement ``window``, ``end_to_end`` and ``replay``."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cell.config
        self.traffic = ctx.cell.traffic
        self.dtype = DTYPES[ctx.cell.precision]
        self.attempted = self.failed = 0
        self.mutate = None
        self.enhancer = None
        self.calls = []
        self._flops = {}

    # ---- set-up ------------------------------------------------------------
    def build(self):
        from prior_diffuse_tpu_torch.config import experiment_from_dict
        from prior_diffuse_tpu_torch.models import complex_prior_class
        from prior_diffuse_tpu_torch.models.diffunet import DiffUNet1
        from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

        exp = experiment_from_dict(self.cfg["experiment"])
        self.exp = exp
        prior_name = exp.model.name
        dev, seed = self.ctx.device, self.ctx.seed
        self.state = {
            "prior": seeded_state(ref.PRIORS[prior_name](), seed, dev, 1),
            "ddpm": seeded_state(ref.DiffUNet1(exp.diffusion.num_steps), seed, dev, 2)}
        prior = complex_prior_class(prior_name)()
        ddpm = DiffUNet1(exp.diffusion.num_steps)
        prior.load_state_dict(self.state["prior"])
        ddpm.load_state_dict(self.state["ddpm"])
        self.enhancer = Enhancer(prior, ddpm, exp, device=dev,
                                 sigma=self.cfg["serving"]["sigma"], dtype=self.dtype)
        self.k3_encoders = (len(exp.diffusion.inference_noise_schedule)
                            + (prior_name == "DiffUNet"))
        if self.mutate is not None:
            self.mutate(self)

    def warm(self, shapes):
        """One ``enhance_batch`` call at each ``(rows, length)``."""
        g = generator(self.ctx.seed, self.ctx.device, 90)
        rng = np.random.default_rng(0)
        for rows, length in shapes:
            self.enhancer.enhance_batch(
                (0.1 * rng.standard_normal((rows, length))).astype(np.float32), g).cpu()

    def call_generator(self, i: int):
        return generator(self.ctx.seed, self.ctx.device, 100, i)

    # ---- the traced window ------------------------------------------------
    def instrument(self, spans):
        """In a traced run: record each batch's shape, and span
        ``enhance_batch`` and ``prior``."""
        enh = self.enhancer
        inner = enh.enhance_batch
        self.shapes = []

        def recorded(wav, *args, **kwargs):
            self.shapes.append(np.shape(wav))
            return inner(wav, *args, **kwargs)

        enh.enhance_batch = recorded
        spans.wrap(enh, "enhance_batch", "enhancer.enhance_batch", sync=True)
        spans.wrap(enh, "prior", "enhancer.prior")

    def trace_counts(self) -> dict:
        """The traced window's batches, their model FLOPs and the least
        time of their encoder stages on K3 (worked out after the window)."""
        bf16 = self.dtype == torch.bfloat16
        return {"batches": len(self.shapes),
                "model_flops": sum(self.batch_flops(r, n) for r, n in self.shapes),
                "k3_bound_s": sum(self.k3_encoders * encoder_bound_s(r, rserve.frames(n), bf16)
                                  for r, n in self.shapes)}

    def batch_flops(self, rows: int, length: int) -> float:
        """Model FLOPs of one batch: the reference prior once and the
        denoiser once a chain step, counted on the meta device."""
        key = (rows, length)
        if key not in self._flops:
            if not hasattr(self, "_meta"):
                exp = self.exp
                self._meta = (ref.PRIORS[exp.model.name]().to("meta").eval(),
                              ref.DiffUNet1(exp.diffusion.num_steps).to("meta").eval())
            prior, ddpm = self._meta
            x = torch.empty((rows, rserve.frames(length), dsp.FREQ, 2), device="meta")
            t = torch.empty((rows,), device="meta")
            steps = len(self.exp.diffusion.inference_noise_schedule)
            with torch.no_grad():
                self._flops[key] = flops_of(prior, x) + steps * flops_of(ddpm, x, x, t)
        return self._flops[key]

    def release(self):
        self.enhancer = None

    # ---- the check ----------------------------------------------------------
    def reference_nets(self, precision: str):
        dev = self.ctx.device
        exp = self.exp
        prior = ref.PRIORS[exp.model.name]()
        ddpm = ref.DiffUNet1(exp.diffusion.num_steps)
        prior.load_state_dict(self.state["prior"])
        ddpm.load_state_dict(self.state["ddpm"])
        prior, ddpm = prior.to(dev).eval(), ddpm.to(dev).eval()
        if precision == "fp8":
            prior, ddpm = rp.fp8_copy(prior), rp.fp8_copy(ddpm)
        return prior, ddpm

    def batch_fn(self, precision: str):
        prior, ddpm = self.reference_nets(precision)
        diff = self.exp.diffusion
        sched = dsp.schedule(diff.noise_schedule, diff.inference_noise_schedule)
        block = self.traffic["reference_rows"]

        def run(wav, x_t):
            with rp.computed_in(precision):
                return rserve.enhance_batch(prior, ddpm, wav, x_t, sched, diff.scale_c, block,
                                            rp.state_rounding(precision))
        return run

    def draw_fn(self, i: int):
        """The draws of call ``i`` as the program made them: the same
        generator, seed and order, in the program's dtype."""
        g = self.call_generator(i)
        return lambda shape: torch.randn(shape, generator=g, device=self.ctx.device,
                                         dtype=self.dtype).float()

    def sample(self) -> list:
        """The calls the check replays: ``check_calls`` drawn from the seed
        among those the window finished, the one that served the longest
        input among them."""
        done = len(self.calls)
        if not done:
            return []
        longest = max(range(done), key=lambda i: self.calls[i]["longest"])
        rng = np.random.default_rng(derived_seed(self.ctx.seed, 7))
        others = [i for i in rng.permutation(done).tolist() if i != longest]
        return sorted([longest] + others[: self.traffic["check_calls"] - 1])

    def outputs(self, precision: str, calls) -> dict:
        fn = self.batch_fn(precision)
        return {i: self.replay(fn, i) for i in calls}

    def check(self) -> list:
        calls = self.sample()
        if not calls:
            return [Reading("wav_rel_err", float("nan"), self.ctx.cell.limits["wav_rel_err"])]
        want = self.outputs("float32", calls)
        worst = max(rel_err(g, w) for i in calls
                    for g, w in zip(self.calls[i]["out"], want[i]))
        return [Reading("wav_rel_err", worst, self.ctx.cell.limits["wav_rel_err"])]

    def control(self, precision: str) -> dict:
        """The control's reading: the reference in ``precision`` against
        the reference in float32, on the check's sample."""
        calls = self.sample()
        want = self.outputs("float32", calls)
        got = self.outputs(precision, calls)
        return {"wav_rel_err": max(rel_err(g, w) for i in calls
                                   for g, w in zip(got[i], want[i]))}
