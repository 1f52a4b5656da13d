"""Long recordings served one at a time through ``enhance_long``.

One closed-loop client sends recording after recording, taken in turn
from a pool of ``pool`` speech-like recordings made from the seed at
set-up (their lengths the quantiles of ``lengths``), in
``inputs.stratified_order`` with ``strata`` strata, so that every block
of ``strata`` recordings of every seed holds the same mix of lengths, to
``serving/streaming.py::enhance_long(enhancer, wav, generator, segment,
overlap, batch_size)``.  Each recording's latency runs from the call to
the returned waveform.  Each call draws from a generator of its own,
seeded from the run's seed and the call's number, so the check can
replay it.

Mix keys: ``pool``, ``lengths``, ``strata``, ``segment``, ``overlap``,
``batch_size``, ``check_calls``, ``reference_rows``, ``trace_seconds``.
"""

from __future__ import annotations

from time import perf_counter

from benchmark.drivers._serving import ServingDriver
from benchmark.harness.inputs import (generator, quantile_lengths, signal_pool,
                                      stratified_order)
from benchmark.harness.trace import percentile
from benchmark.reference import serve as rserve


class Driver(ServingDriver):
    def setup(self):
        t = self.traffic
        self.build()
        self.ctx.mark("build")
        lengths = quantile_lengths(t["pool"], t["lengths"])
        self.pool = signal_pool(lengths, self.ctx.seed, self.ctx.device, 4)
        self.order = stratified_order(lengths, t["strata"], self.ctx.seed, 4)
        self.ctx.mark("inputs")
        rows = set()
        for w in self.pool:
            n = len(range(0, len(w) - t["overlap"], t["segment"] - t["overlap"]))
            rows.update(min(t["batch_size"], n - i) for i in range(0, n, t["batch_size"]))
        self.warm([(r, t["segment"]) for r in sorted(rows)])
        self.serve(0, generator(self.ctx.seed, self.ctx.device, 91))
        self.ctx.mark("warm-up")

    def serve(self, j: int, g):
        from prior_diffuse_tpu_torch.serving.streaming import enhance_long

        t = self.traffic
        return enhance_long(self.enhancer, self.pool[j], g, segment=t["segment"],
                            overlap=t["overlap"], batch_size=t["batch_size"])

    def window(self, seconds, spans):
        if spans is not None:
            self.instrument(spans)
        t0 = perf_counter()
        while True:
            i = len(self.calls)
            j = int(self.order[i % len(self.pool)])
            start = perf_counter()
            if spans is not None:
                with spans.span("client.enhance_long"):
                    out = self.serve(j, self.call_generator(i))
            else:
                out = self.serve(j, self.call_generator(i))
            self.calls.append({"file": j, "out": [out], "latency_s": perf_counter() - start,
                               "longest": len(self.pool[j])})
            self.attempted += 1
            if perf_counter() - t0 >= seconds:
                break

    def end_to_end(self, window_s: float) -> dict:
        lat = [c["latency_s"] * 1e3 for c in self.calls]
        return {"recording_ms_p95": (percentile(lat, 95), "ms")}

    def replay(self, batch_fn, i: int) -> list:
        t = self.traffic
        return [rserve.enhance_long(batch_fn, self.pool[self.calls[i]["file"]], self.draw_fn(i),
                                    t["segment"], t["overlap"], t["batch_size"])]
