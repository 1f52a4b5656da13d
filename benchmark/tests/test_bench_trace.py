"""The idle-union, percentile and rate arithmetic, and the metric readers,
on synthetic readings."""

import numpy as np
import pytest

from benchmark.harness import core, trace


def test_union_and_gaps():
    iv = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert trace.union_seconds(iv) == 12 + 10 + 1
    assert trace.gaps(iv) == [(12, 20), (30, 40)]
    assert trace.union_seconds([]) == 0


def test_percentile():
    assert trace.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert trace.percentile([3.0], 95) == 3.0


def summary(**counts):
    spans = trace.Spans(cuda=False)
    spans.host = {"client.enhance_long": [1.0, 1.0], "enhancer.enhance_batch": [0.7, 0.6]}
    return trace.TraceSummary(window_s=2.0, busy_s=1.5,
                              device_ops={"void enc_chain_kernel<64>": 0.2,
                                          "void enc_chain_bf16_kernel": 0.1, "gemm": 0.5},
                              launches=600, idle_gaps=[("aten::copy_", 0.01)], spans=spans,
                              counts=counts)


def test_readers():
    m = core.metrics()
    t = summary(batches=3, steps=4, model_flops=989e12 * 0.02, k3_bound_s=0.05)
    assert m["device_idle_pct.files"].read(t) == pytest.approx(25.0)
    assert m["mfu.files"].read(t) == pytest.approx(1.0)
    assert m["k3_roofline.files"].read(t) == pytest.approx(25.0)
    assert m["k3bf16_roofline.recordings"].read(t) == pytest.approx(50.0)
    assert m["launches_per_batch.recordings"].read(t) == pytest.approx(200.0)
    assert m["launches_per_step.train"].read(t) == pytest.approx(150.0)
    assert m["front_share_pct.recordings"].read(t) == pytest.approx(35.0)


def test_readers_find_nothing_and_say_so():
    t = trace.TraceSummary(1.0, 0.0, {}, 0, [], trace.Spans(cuda=False), {})
    for metric in core.metrics().values():
        assert metric.read(t) is None, metric.name


def test_breakdown_is_sorted_and_short():
    b = summary().breakdown()
    assert b["device_ops"][0] == ["gemm", 0.5] and len(b["device_ops"]) <= 10


def test_rates_take_all_the_work_over_all_the_time():
    from benchmark.drivers.files import Driver as Files
    from benchmark.drivers.recordings import Driver as Recordings

    f = Files.__new__(Files)
    f.pool = [np.zeros(16000), np.zeros(32000)]
    f.calls = [{"files": [0, 1]}, {"files": [1, 1]}]
    assert f.end_to_end(2.0)["audio_s_per_s"][0] == pytest.approx((3 + 4) / 2.0)
    r = Recordings.__new__(Recordings)
    r.calls = [{"latency_s": s / 1000} for s in range(1, 201)]
    assert r.end_to_end(9.0)["recording_ms_p95"][0] == pytest.approx(190.05)
