"""The port's own spans and counters (``utils/profiler.py``: ``span``,
``count``, ``snapshot``, ``reset``, ``attribute``) and the benchmark's
per-layer metrics that read them (CPU).

* Off (no profiler running): ``enhance_files`` on a small seeded
  ``Enhancer`` and one ``_train_step`` open no ``record_function`` of the
  program's, create no CUDA event and leave the registry empty.
* On (under a CPU ``torch.profiler.profile``): the same calls give the
  span tree of the serving front end, the enhancer and the train step,
  one request id a call or step, and each registry span lies within
  100 us of the profiler's own annotation of it.
* The front end's counters against a hand count through ``_buckets``.
* Only a span given a CUDA device records CUDA events.
* ``attribute`` and ``requests`` on synthetic spans; ``trace()``'s
  ``spans.json`` around a serving call.
* Each of the six ``benchmark/metrics`` readers of the registry on a
  built registry, on an empty one, and on a program without one; their
  ``BENCHMARK.json`` entries.

Full-width ``DiffUNet`` + ``DiffUNet1`` at 2 x 2400 samples.
"""

import contextlib
import gc
import json
import os
import time
import wave

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import core as bench
from benchmark.harness.trace import Spans, TraceSummary
from prior_diffuse_tpu_torch.config import ExperimentConfig, RunConfig, TrainConfig
from prior_diffuse_tpu_torch.serving.enhance import PriorServer, _buckets, enhance_files
from prior_diffuse_tpu_torch.serving.enhancer import Enhancer
from prior_diffuse_tpu_torch.serving.streaming import enhance_long
from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer, seeded_nets
from prior_diffuse_tpu_torch.utils import profiler

# parallel test workers: cap torch's OpenMP pool (see test_torch_trainer.py)
torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENGTH = 2400
PREFIXES = ("front.", "enh.", "train.")
ALIGN_NS = 100_000
CHAIN = ["enh.step"] * 6  # the fast schedule's six reverse steps
BATCH_TREE = ["enh.upload", "enh.features", "enh.prior", *CHAIN, "enh.istft"]


@pytest.fixture(autouse=True)
def clean_registry():
    profiler.reset()
    yield
    profiler.reset()


@pytest.fixture(scope="module")
def enhancer():
    dis, ddpm = seeded_nets(3, 50, 2)
    return Enhancer(dis, ddpm, ExperimentConfig(), device="cpu")


def _wav(path, samples):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.zeros(samples, np.int16).tobytes())


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing")
    data = str(root / "data")
    for kind in ("noisy", "clean"):
        for split in ("trainset", "testset"):
            _wav(os.path.join(data, f"{kind}_{split}_wav", "u0.wav"), LENGTH)
    exp = ExperimentConfig(train=TrainConfig(batch_size=2, chunk_length=LENGTH))
    run = RunConfig(seed=5, joint=True, sigma=True, data_root=data, assets=str(root / "assets"))
    return ComplexDDPMTrainer(run, exp, device="cpu")


def _files(seed, lengths=(2400, 1900, 1500)):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in lengths]


def _step(trainer, norms=True):
    rng = np.random.default_rng(9)
    noisy, clean = (torch.from_numpy((0.1 * rng.standard_normal((2, LENGTH))).astype(np.float32))
                    for _ in range(2))
    frames = torch.full((2,), LENGTH // 160 + 1, dtype=torch.int64)
    return trainer._train_step(noisy, clean, frames, norms=norms)


class _Clock:
    """``time`` for the profiler module whose ``time_ns`` also notes the
    thread's CPU time (``stamps``: ``(wall ns, thread CPU ns)`` a call), so
    that the time the thread spent off the CPU between two stamps is
    known."""

    def __init__(self):
        self.stamps = []

    def time_ns(self):
        wall = time.time_ns()
        self.stamps.append((wall, time.thread_time_ns()))
        return wall

    def __getattr__(self, name):
        return getattr(time, name)


class _Marked(torch.autograd.profiler.record_function):
    """``record_function`` whose closing call first stamps ``clock``."""

    clock = None

    def __exit__(self, *exc):
        _Marked.clock.time_ns()
        return super().__exit__(*exc)


@contextlib.contextmanager
def _cpu_profile():
    """A CPU capture whose first annotation (the slowest to open) is not
    the program's, with the garbage collector off (a collection inside the
    call that opens an annotation would part the profiler's stamp from the
    registry's by its own length, which says nothing of their clocks), and
    the registry's clock noted (``prof.clock``) with a stamp where each
    annotation's closing call starts."""
    enabled, clock, real = gc.isenabled(), _Clock(), torch.autograd.profiler.record_function
    gc.disable()
    profiler.time, _Marked.clock = clock, clock
    torch.autograd.profiler.record_function = _Marked
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            prof.clock = clock
            with torch.autograd.profiler.record_function("warm-up"):
                pass
            yield prof
    finally:
        profiler.time = time
        torch.autograd.profiler.record_function = real
        if enabled:
            gc.enable()


def _tree(snap):
    """``(name, parent name)`` of each span, in order of opening."""
    spans = snap["spans"]
    return [(s["name"], spans[s["parent"]]["name"] if s["parent"] >= 0 else None)
            for s in spans]


def _assert_aligned(prof, snap):
    """Each registry span within ALIGN_NS of the profiler's annotation of
    the same name (the k-th of each name with the k-th).  The registry's
    start is the middle of the call that opens the annotation, inside which
    the profiler stamps its own; its end follows the call that closes it,
    inside which the profiler stamps.  The time the thread spent off the
    CPU inside the one call, or between the other's start and the end, is
    the scheduler's and not a clock's, and is allowed on top."""
    notes = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            notes.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    stamps = prof.clock.stamps
    pairs = [((w0 + w1) // 2, w1, (w1 - w0) - (c1 - c0))
             for (w0, c0), (w1, c1) in zip(stamps, stamps[1:])]
    off_opening = {mid: off for mid, _, off in pairs}
    off_closing = {w1: off for _, w1, off in pairs}
    mine = {}
    for s in snap["spans"]:
        mine.setdefault(s["name"], []).append((s["start_ns"], s["end_ns"]))
    assert mine
    for name, spans in mine.items():
        theirs = sorted(notes[name])
        assert len(theirs) == len(spans), name
        for (a, b), (c, d) in zip(spans, theirs):
            assert abs(a - c) <= ALIGN_NS + off_opening[a], (name, a - c, off_opening[a])
            assert abs(b - d) <= ALIGN_NS + off_closing[b], (name, b - d, off_closing[b])


# ---- off ---------------------------------------------------------------------


def test_off_path_records_nothing(enhancer, trainer, monkeypatch):
    opened, events = [], []
    real = torch.autograd.profiler.record_function

    def counting(name, *args, **kwargs):
        opened.append(name)
        return real(name, *args, **kwargs)

    class Event:
        def __init__(self, *args, **kwargs):
            events.append(args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    assert not profiler.tracing()
    enhance_files(enhancer, _files(0), torch.Generator().manual_seed(0), batch_size=2,
                  bucket_samples=1600)
    _step(trainer)
    assert [n for n in opened if n.startswith(PREFIXES)] == []
    assert events == []
    snap = profiler.snapshot()
    assert snap["spans"] == []
    assert {k: v for k, v in snap["counters"].items() if not k.startswith("kernel.")} == {}


# ---- on ----------------------------------------------------------------------


def test_enhance_files_span_tree(enhancer):
    with _cpu_profile() as prof:
        for seed in (1, 2):
            enhance_files(enhancer, _files(seed), torch.Generator().manual_seed(seed),
                          batch_size=2, bucket_samples=1600)
    snap = profiler.snapshot()
    batch = ([("front.prepare", "front.call"), ("enh.batch", "front.call")]
             + [(n, "enh.batch") for n in BATCH_TREE] + [("front.finish", "front.call")])
    call = [("front.call", None)] + batch * 2  # 3 files in batches of 2
    assert _tree(snap) == call * 2
    requests = [s["request"] for s in snap["spans"]]
    half = len(requests) // 2
    assert len(set(requests[:half])) == len(set(requests[half:])) == 1
    assert requests[0] != requests[-1]
    assert all(s["stream_ms"] is None for s in snap["spans"])  # no CUDA events
    _assert_aligned(prof, snap)


def test_train_step_span_tree(trainer):
    with _cpu_profile() as prof:
        _step(trainer, norms=True)
        _step(trainer, norms=False)
    snap = profiler.snapshot()
    phases = ["train.features", "train.forward", "train.backward"]
    want = ([("train.step", None)] + [(p, "train.step") for p in phases]
            + [("train.norms", "train.step"), ("train.optimizer", "train.step")]
            + [("train.step", None)] + [(p, "train.step") for p in phases]
            + [("train.optimizer", "train.step")])
    assert _tree(snap) == want
    first, second = ({s["request"] for s in snap["spans"][a:b]} for a, b in ((0, 6), (6, 11)))
    assert len(first) == len(second) == 1 and first != second
    _assert_aligned(prof, snap)


def test_prior_server_and_enhance_long_span_trees(enhancer):
    server = PriorServer(enhancer.dis, enhancer.cfg, "cpu")
    wav = _files(4, (10000,))[0]
    with _cpu_profile():
        server.enhance_batch(np.zeros((2, LENGTH), np.float32))
        enhance_long(enhancer, wav, torch.Generator().manual_seed(4), segment=4800,
                     overlap=480, batch_size=2)
    tree = _tree(profiler.snapshot())
    assert tree[:5] == [("enh.batch", None), ("enh.upload", "enh.batch"),
                        ("enh.features", "enh.batch"), ("enh.prior", "enh.batch"),
                        ("enh.istft", "enh.batch")]
    batch = [("enh.batch", "front.call")] + [(n, "enh.batch") for n in BATCH_TREE]
    # 10000 samples: segments at 0, 4320 and 8640, batches of 2 and 1
    assert tree[5:] == ([("front.call", None), ("front.segment", "front.call")] + batch * 2
                        + [("front.finish", "front.call")])


def test_spans_nest_count_and_reset():
    with profiler.span("a"):  # off
        profiler.count("c", 3)
    assert profiler.snapshot()["spans"] == []
    with _cpu_profile():
        assert profiler.tracing()
        with profiler.span("a"):
            with profiler.span("b"):
                profiler.count("c", 3)
            profiler.count("c")
        with profiler.span("a"):
            pass
    snap = profiler.snapshot()
    assert [(s["name"], s["parent"]) for s in snap["spans"]] == [("a", -1), ("b", 0), ("a", -1)]
    assert [s["request"] for s in snap["spans"]][:2] == [snap["spans"][0]["request"]] * 2
    assert snap["spans"][2]["request"] != snap["spans"][0]["request"]
    assert snap["counters"]["c"] == 4
    assert {"kernel.k1", "kernel.k2", "kernel.k3", "kernel.k3_bf16"} <= set(snap["counters"])
    totals = profiler.span_totals(snap["spans"])
    assert totals["a"]["calls"] == 2
    assert totals["a"]["self_host_s"] == pytest.approx(
        totals["a"]["host_s"] - totals["b"]["host_s"], abs=1e-12)
    profiler.reset()
    assert profiler.snapshot()["spans"] == [] and "c" not in profiler.snapshot()["counters"]


def test_only_a_span_given_a_cuda_device_records_events(monkeypatch):
    """A span records CUDA events only where its caller passes a CUDA
    device: its children of host work, passing none, record none."""
    made = []

    class Event:
        def __init__(self, *args, **kwargs):
            made.append(self)

        def record(self):
            pass

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return 2.5

    monkeypatch.setattr(torch.cuda, "Event", Event)
    with _cpu_profile():
        with profiler.span("outer", "cuda"):
            with profiler.span("inner"):
                pass
        with profiler.span("host"):
            pass
    assert len(made) == 2
    assert [s["stream_ms"] for s in profiler.snapshot()["spans"]] == [2.5, None, None]


def test_requests_split_each_call_by_span():
    spans = [_span("front.call", 0, 100), _span("enh.step", 10, 30, 0),
             _span("enh.step", 30, 60, 0), _span("front.call", 200, 250),
             _span("front.prepare", 200, 205, 3)]
    spans[3]["request"] = spans[4]["request"] = 2
    got = profiler.requests(spans)
    assert [(r["request"], r["name"]) for r in got] == [(1, "front.call"), (2, "front.call")]
    assert got[0]["host_s"] == pytest.approx(0.1)
    assert got[0]["spans"] == {"enh.step": pytest.approx(0.05)}
    assert got[1]["spans"] == {"front.prepare": pytest.approx(0.005)}


def test_trace_writes_spans_json_for_a_serving_call(enhancer, tmp_path):
    """``trace()`` around ``enhance_files``: ``spans.json`` holds the front
    end's and the enhancer's spans, the call as one request, and the
    capture's counters."""
    with profiler.trace(str(tmp_path)):
        enhance_files(enhancer, _files(5), torch.Generator().manual_seed(5), batch_size=2,
                      bucket_samples=1600)
    with open(tmp_path / "spans.json") as f:
        report = json.load(f)
    calls = {k: v["calls"] for k, v in report["spans"].items()}
    assert calls == {"front.call": 1, "front.prepare": 2, "front.finish": 2, "enh.batch": 2,
                     "enh.upload": 2, "enh.features": 2, "enh.prior": 2, "enh.step": 12,
                     "enh.istft": 2}
    [request] = report["requests"]
    assert request["name"] == "front.call" and request["spans"]["enh.step"] > 0
    c = report["counters"]
    assert (c["front.audio_samples"], c["front.padded_samples"]) == (5800, 2 * 3200 + 3200)
    assert {"kernel.k1", "kernel.k2", "kernel.k3", "kernel.k3_bf16"} <= set(c)


# ---- counters ------------------------------------------------------------------


class _Stub:
    """What ``enhance_files`` and ``enhance_long`` read of an enhancer."""

    device = torch.device("cpu")
    cfg = ExperimentConfig(train=TrainConfig(batch_size=2))

    def enhance_batch(self, wav, generator=None):
        return torch.as_tensor(wav)


def test_front_counters_files():
    lengths = [1000, 2500, 4000, 1700, 900]
    wavs = [np.ones(n, np.float32) for n in lengths]
    with _cpu_profile():
        enhance_files(_Stub(), wavs, None, batch_size=2, bucket_samples=1600)
    c = profiler.snapshot()["counters"]
    # sorted 900, 1000 | 1700, 2500 | 4000: rows 2, 2, 1 on the 1600, 3200
    # and 4800 rungs of the x1.5 ladder
    assert (c["front.audio_samples"], c["front.padded_samples"]) == (
        10100, 2 * 1600 + 2 * 3200 + 1 * 4800)
    buckets = list(_buckets(lengths, 2, 1600))
    assert c["front.padded_samples"] == sum(rows * pad for _, rows, pad in buckets)
    assert c["front.audio_samples"] == sum(lengths[j] for idx, _, _ in buckets for j in idx)


def test_front_counters_long():
    with _cpu_profile():
        enhance_long(_Stub(), np.ones(10000, np.float32), None, segment=4800, overlap=480,
                     batch_size=2)
    c = profiler.snapshot()["counters"]
    # segments at 0, 4320, 8640: 4800 + 4800 + 1360 samples of the recording
    assert (c["front.audio_samples"], c["front.padded_samples"]) == (10960, 3 * 4800)


# ---- attribution ----------------------------------------------------------------


def test_attribute_on_synthetic_intervals():
    spans = [("s", 0, 100), ("t", 40, 60), ("s", 200, 300)]
    # (start, end, correlation) on the device; launches by correlation
    ops = [(10, 30, 1), (50, 90, 2), (80, 120, 3), (250, 260, 4), (400, 410, 5)]
    launch = {1: 5, 2: 45, 3: 55, 4: 210, 5: 390}
    got = profiler.attribute(spans, ops, launch)
    assert got["s"]["launches"] == 4 and got["t"]["launches"] == 2
    # s: 10-30 and 50-120 from the first, 250-260 from the second
    assert got["s"]["device_busy_s"] == pytest.approx((20 + 70 + 10) / 1e9)
    assert got["t"]["device_busy_s"] == pytest.approx(70 / 1e9)
    # idle under s: 0-10, 30-50 of 0-100; 200-250, 260-300 of 200-300
    assert got["s"]["device_idle_s"] == pytest.approx((10 + 20 + 50 + 40) / 1e9)
    assert got["t"]["device_idle_s"] == pytest.approx(10 / 1e9)  # 40-50


# ---- the benchmark's readers ----------------------------------------------------

FILES = ["diffunet.files-f32", "dbaiat.files-f32"]
NEW = {
    "front_host_pct.files": ("%", "program_span", "serving front end", "audio_s_per_s", FILES),
    "pad_waste_pct.files": ("%", "program_counter", "serving front end", "audio_s_per_s",
                            FILES),
    "chain_step_ms.files": ("ms", "program_span", "enhancer", "audio_s_per_s", FILES),
    "front_host_pct.recordings": ("%", "program_span", "serving front end",
                                  "recording_ms_p95", ["diffunet.recordings-bf16"]),
    "dispatch_pct.recordings": ("%", "program_span", "enhancer", "recording_ms_p95",
                                ["diffunet.recordings-bf16"]),
    "optimizer_share_pct.train": ("%", "program_span", "trainer", "train_utt_per_s",
                                  ["diffunet.train-f32"]),
}


def _span(name, start_ms, end_ms, parent=-1, stream_ms=None):
    return {"name": name, "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6),
            "parent": parent, "request": 1, "stream_ms": stream_ms}


BUILT = {
    "spans": [
        _span("front.call", 0, 1000),                             # 0
        _span("front.prepare", 0, 30, 0),                         # 1
        _span("enh.batch", 30, 530, 0, 400.0),                    # 2
        _span("enh.upload", 30, 50, 2, 5.0),                      # 3
        _span("enh.step", 100, 150, 2, 30.0),                     # 4
        _span("enh.step", 150, 200, 2, 34.0),                     # 5
        _span("front.finish", 900, 950, 0),                       # 6
        _span("front.segment", 950, 960, 0),                      # 7
        _span("train.step", 1000, 1600, -1, 500.0),               # 8
        _span("train.norms", 1400, 1450, 8, 10.0),                # 9
        _span("train.optimizer", 1450, 1600, 8, 15.0),            # 10
    ],
    "counters": {"front.padded_samples": 14400, "front.audio_samples": 10100},
}
# over a window of 2 s
WANT = {
    "front_host_pct.files": 100 * (0.030 + 0.050) / 2,
    "pad_waste_pct.files": 100 * (14400 - 10100) / 14400,
    "chain_step_ms.files": 32.0,
    "front_host_pct.recordings": 100 * (0.010 + 0.050) / 2,
    "dispatch_pct.recordings": 100 * (0.500 - 0.020) / 2,
    "optimizer_share_pct.train": 100 * 25 / 500,
}


def _summary():
    return TraceSummary(2.0, 1.0, {}, 0, [], Spans(cuda=False), {})


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_on_a_built_registry(name):
    assert bench.metrics()[name].read(_summary(), BUILT) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_finds_nothing_in_an_empty_registry(name):
    metric = bench.metrics()[name]
    assert metric.read(_summary(), {"spans": [], "counters": {}}) is None
    assert metric.read(_summary()) is None  # the program's own, empty off a capture


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_without_the_program_registry(name, monkeypatch):
    """A program without ``snapshot`` (the commit before it) reads None."""
    monkeypatch.delattr(profiler, "snapshot")
    assert bench.metrics()[name].read(_summary()) is None


def test_readers_read_a_traced_call(enhancer):
    """The files readers on the registry of a real call: padding as the
    buckets give it, the front end's host share inside the window."""
    with _cpu_profile():
        enhance_files(enhancer, _files(7), torch.Generator().manual_seed(7), batch_size=2,
                      bucket_samples=1600)
    m, t = bench.metrics(), _summary()
    assert m["pad_waste_pct.files"].read(t) == pytest.approx(
        100 * (2 * 3200 + 1 * 3200 - 5800) / (2 * 3200 + 1 * 3200))
    assert 0 < m["front_host_pct.files"].read(t) < 100
    assert m["chain_step_ms.files"].read(t) is None  # no CUDA events on the CPU


def test_manifest_entries_match_the_metric_files():
    manifest = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    files = bench.metrics()
    for name, (unit, source, layer, moves, cells) in NEW.items():
        e, f = entries[name], files[name]
        assert (e["unit"], e["source"], e["layer"], e["moves"], e["workloads"]) == (
            unit, source, layer, moves, cells)
        assert (f.unit, f.layer, f.moves, f.workloads) == (unit, layer, moves, cells)
        assert e["better"] == "lower"
