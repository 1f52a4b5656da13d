"""A stream of files served in calls of ``enhance_files``.

One closed-loop client sends call after call of ``per_call`` files, taken
in turn from a pool of ``pool`` speech-like files made from the seed at
set-up, to ``serving/enhance.py::enhance_files(enhancer, wavs, generator,
batch_size, bucket_samples)``.  The pool's lengths are the quantiles of
``lengths``; the calls take the pool in ``inputs.stratified_order`` with
one stratum a file of a call, so every call of every seed holds the same
mix of lengths, and only which files and their content hang on the seed.
Each call draws from a generator of its own, seeded from the run's seed
and the call's number, so the check can replay it.

Mix keys: ``pool``, ``per_call``, ``batch_size``, ``bucket_samples``,
``lengths`` (``inputs.quantile_lengths``), ``check_calls``,
``reference_rows``, ``trace_seconds``.
"""

from __future__ import annotations

from time import perf_counter

from benchmark.drivers._serving import ServingDriver
from benchmark.harness.inputs import (SR, generator, quantile_lengths, signal_pool,
                                      stratified_order)
from benchmark.reference import serve as rserve


class Driver(ServingDriver):
    def setup(self):
        t = self.traffic
        self.build()
        self.ctx.mark("build")
        lengths = quantile_lengths(t["pool"], t["lengths"])
        self.pool = signal_pool(lengths, self.ctx.seed, self.ctx.device, 3)
        self.order = stratified_order(lengths, t["per_call"], self.ctx.seed, 3)
        self.ctx.mark("inputs")
        # a batch's rung is that of its longest file, one of the pool's
        rungs = sorted({rserve.ladder_pad(len(w), t["bucket_samples"]) for w in self.pool})
        rows = {rserve.ladder_rows(min(t["batch_size"], t["per_call"]), t["batch_size"])}
        if t["per_call"] % t["batch_size"]:
            rows.add(rserve.ladder_rows(t["per_call"] % t["batch_size"], t["batch_size"]))
        self.warm([(r, n) for r in sorted(rows) for n in rungs])
        self.serve(self.files(0), generator(self.ctx.seed, self.ctx.device, 91))
        self.ctx.mark("warm-up")

    def files(self, i: int) -> list:
        """Indices into the pool of call ``i``'s files."""
        n, k = len(self.pool), self.traffic["per_call"]
        return [int(self.order[(i * k + j) % n]) for j in range(k)]

    def serve(self, idx, g):
        from prior_diffuse_tpu_torch.serving.enhance import enhance_files

        return enhance_files(self.enhancer, [self.pool[j] for j in idx], g,
                             batch_size=self.traffic["batch_size"],
                             bucket_samples=self.traffic["bucket_samples"])

    def window(self, seconds, spans):
        if spans is not None:
            self.instrument(spans)
        t0 = perf_counter()
        while True:
            i = len(self.calls)
            idx = self.files(i)
            if spans is not None:
                with spans.span("client.enhance_files"):
                    out = self.serve(idx, self.call_generator(i))
            else:
                out = self.serve(idx, self.call_generator(i))
            self.calls.append({"files": idx, "out": out,
                               "longest": max(len(self.pool[j]) for j in idx)})
            self.attempted += len(idx)
            if perf_counter() - t0 >= seconds:
                break

    def end_to_end(self, window_s: float) -> dict:
        audio = sum(len(self.pool[j]) for c in self.calls for j in c["files"]) / SR
        return {"audio_s_per_s": (audio / window_s, "audio-s/s")}

    def replay(self, batch_fn, i: int) -> list:
        t = self.traffic
        return rserve.enhance_files(batch_fn, [self.pool[j] for j in self.calls[i]["files"]],
                                    self.draw_fn(i), t["batch_size"], t["bucket_samples"])
