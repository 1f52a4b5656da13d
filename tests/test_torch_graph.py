"""The bf16 enhancer's CUDA-graph batch (``serving/enhancer.py``:
``batch_rung``, ``BatchGraph``, ``Enhancer._graphed_batch``).

CPU: the rung table; the CPU and float32 paths keep no graph and count
nothing under a trace; the padded-row bookkeeping with the eager forward
standing in for the capture and the replay (the draws at the batch's own
shape, the generator left as the eager path leaves it, the rows past the
batch zeroed, only the batch's rows returned, the counters, the graphs
dropped on a weight change, a replay leaving the kernel counters to the
wrappers).

Card (marked ``card``, skipped without one; this file imports no JAX, so it
runs on the card with ``python -m pytest tests/test_torch_graph.py -m card
--noconftest``): the replay against the eager path bit for bit at the
rung's rows and within the streaming tests' bf16 bound at the batch's own
rows, a weight change recaptured, a 45-segment recording through
``enhance_long`` graphed against eager at the same padding, the
kernels a replay runs (from a device trace) and the wrappers' counters it
leaves alone, and the other complex priors.

Full-width ``DiffUNet`` + ``DiffUNet1`` on the CPU at 3 x 2400 samples.
"""

import copy
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from prior_diffuse_tpu_torch.config import ExperimentConfig, TrainConfig
from prior_diffuse_tpu_torch.ops.cuda import convblock, stft as kstft
from prior_diffuse_tpu_torch.serving.enhancer import BatchGraph, Enhancer, batch_rung
from prior_diffuse_tpu_torch.serving.streaming import enhance_long
from prior_diffuse_tpu_torch.signal.stft import frame_count
from prior_diffuse_tpu_torch.training.ddpm_trainer import seeded_nets
from prior_diffuse_tpu_torch.utils import profiler

# parallel test workers: cap torch's OpenMP pool (see test_torch_trainer.py)
torch.set_num_threads(min(2, torch.get_num_threads()))

LENGTH = 2400
GRAPH_COUNTERS = ("enh.graph_replays", "enh.graph_captures", "enh.graph_pad_rows")
# the bf16 waveform bound of tests/test_torch_streaming.py
BF16_WAVE_REL_RMS = 4e-2
WRAPPERS = (kstft.stft, kstft.istft, convblock.enc_stage, convblock.enc_stage_bf16)
_REPLAY = BatchGraph.replay


@pytest.fixture(autouse=True)
def clean_registry():
    profiler.reset()
    yield
    profiler.reset()


@pytest.fixture(scope="module")
def nets():
    return seeded_nets(3, 50, 2)


def _wav(rows, length=LENGTH, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal((rows, length))).astype(np.float32)


def _x_T(rows, seed, length=LENGTH, device="cpu"):
    return torch.randn((1, rows, frame_count(length), 161, 2), dtype=torch.bfloat16,
                       device=device, generator=torch.Generator(device).manual_seed(seed))


def _launch_counts():
    return [fn.launches for fn in WRAPPERS]


def _rel_rms(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float(torch.sqrt(torch.mean((got - want) ** 2) / torch.mean(want ** 2)))


def test_batch_rung_table():
    table = {rows: batch_rung(rows) for rows in range(1, 33)}
    assert table == {rows: 4 * ((rows + 3) // 4) for rows in range(1, 33)}
    assert sorted(set(table.values())) == [4, 8, 12, 16, 20, 24, 28, 32]
    assert [table[r] for r in (1, 4, 5, 13, 16, 17, 29, 32)] == [4, 4, 8, 16, 16, 20, 32, 32]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cpu_and_f32_enhancers_run_eagerly(nets, dtype):
    enh = Enhancer(*nets, ExperimentConfig(), device="cpu", dtype=dtype)
    wav = _wav(3)
    with profile(activities=[ProfilerActivity.CPU]):
        out = enh.enhance_batch(wav, torch.Generator().manual_seed(5))
        counted = profiler.counters()
    assert enh._graphs == {}
    assert all(counted.get(name, 0) == 0 for name in GRAPH_COUNTERS)
    assert torch.equal(out, enh.eager_batch(wav, torch.Generator().manual_seed(5)))


@pytest.fixture
def graphed(nets, monkeypatch):
    """A bf16 enhancer on the CPU whose graphs' capture and replay are the
    eager forward on the static buffers."""
    monkeypatch.setattr(BatchGraph, "capture", BatchGraph.forward)
    monkeypatch.setattr(BatchGraph, "replay", BatchGraph.forward)
    return Enhancer(*copy.deepcopy(nets), ExperimentConfig(), device="cpu",
                    dtype=torch.bfloat16)


def test_graph_draws_at_the_batch_rows(graphed):
    g, g_eager = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    graphed._graphed_batch(_wav(3), g)
    graphed.eager_batch(_wav(3), g_eager)
    assert torch.equal(g.get_state(), g_eager.get_state())
    graph = graphed._graphs[(4, LENGTH)]
    noise, x_T = graph.draws
    assert noise is None and x_T.shape == (1, 4, frame_count(LENGTH), 161, 2)
    assert torch.equal(x_T[:, :3], _x_T(3, 7))
    assert not x_T[:, 3:].any()


def test_graph_zeroes_the_rows_past_the_batch(graphed):
    graphed._graphed_batch(_wav(4, seed=1), torch.Generator().manual_seed(1))
    graph = graphed._graphs[(4, LENGTH)]
    assert graph.wav.all() and graph.draws[1].all()
    graphed._graphed_batch(_wav(1, seed=2), torch.Generator().manual_seed(2))
    assert graphed._graphs == {(4, LENGTH): graph}
    assert torch.equal(graph.wav[:1], torch.from_numpy(_wav(1, seed=2)))
    assert not graph.wav[1:].any() and not graph.draws[1][:, 1:].any()


def test_graph_returns_the_batch_rows(graphed):
    wav, x_T = _wav(3, seed=3), _x_T(3, 11)
    out = graphed._graphed_batch(wav, None, x_T)
    assert out.shape == (3, LENGTH) and out.dtype == torch.float32
    graph = graphed._graphs[(4, LENGTH)]
    out[:] = 0  # the result is the caller's: it does not alias the static output
    again = graphed._graphed_batch(wav, None, x_T)
    assert again.data_ptr() != out.data_ptr() and again.any()
    assert torch.equal(again, graph.forward()[:3])
    assert torch.equal(again, graphed.eager_batch(wav, x_T=x_T))


def test_graph_counters_under_a_trace(graphed):
    with profile(activities=[ProfilerActivity.CPU]):
        graphed._graphed_batch(_wav(3), torch.Generator().manual_seed(1))
        graphed._graphed_batch(_wav(2), torch.Generator().manual_seed(2))
        graphed._graphed_batch(_wav(5, seed=4), torch.Generator().manual_seed(3))
        snap = profiler.snapshot()
    assert {k: snap["counters"].get(k, 0) for k in GRAPH_COUNTERS} == {
        "enh.graph_replays": 1, "enh.graph_captures": 2, "enh.graph_pad_rows": 1 + 2 + 3}
    assert [s["name"] for s in snap["spans"]].count("enh.replay") == 1
    assert sorted(graphed._graphs) == [(4, LENGTH), (8, LENGTH)]


@pytest.mark.parametrize("change", ["load_state_dict", "in_place"])
def test_a_weight_change_drops_the_graphs(graphed, change):
    wav, x_T = _wav(3, seed=5), _x_T(3, 12)
    before = graphed._graphed_batch(wav, None, x_T)
    old = graphed._graphs[(4, LENGTH)]
    graphed._graphed_batch(_wav(6), torch.Generator().manual_seed(1))
    assert len(graphed._graphs) == 2
    with torch.no_grad():
        if change == "in_place":
            for p in graphed.ddpm.parameters():
                p.mul_(1.5)
        else:
            state = {k: v * 1.5 if v.is_floating_point() else v
                     for k, v in graphed.dis.state_dict().items()}
            graphed.dis.load_state_dict(state)
    after = graphed._graphed_batch(wav, None, x_T)
    assert list(graphed._graphs) == [(4, LENGTH)] and graphed._graphs[(4, LENGTH)] is not old
    assert not torch.equal(after, before)
    assert torch.equal(after, graphed.eager_batch(wav, x_T=x_T))


def test_load_draws_places_step_noise_and_x_T(graphed):
    graph = BatchGraph(graphed, 8, LENGTH)
    t = frame_count(LENGTH)
    noise = torch.randn((2, 6, 5, t, 161, 2))
    x_T = torch.randn((2, 5, t, 161, 2))
    graph.load_draws(noise, x_T)
    assert graph.draws[0].shape == (2, 6, 8, t, 161, 2) and graph.draws[1].shape == (2, 8, t, 161, 2)
    assert torch.equal(graph.draws[0][:, :, :5], noise) and not graph.draws[0][:, :, 5:].any()
    assert torch.equal(graph.draws[1][:, :5], x_T) and not graph.draws[1][:, 5:].any()
    with pytest.raises(ValueError):
        graph.load_draws(noise, None)
    with pytest.raises(ValueError):
        graph.load_draws(noise[:1], x_T)


def test_a_replay_leaves_the_kernel_counters_to_the_wrappers(graphed):
    graph = BatchGraph(graphed, 4, LENGTH)
    graph.graph = types.SimpleNamespace(replay=lambda: None)
    graph.out = torch.zeros(4, LENGTH)
    before = _launch_counts()
    for _ in range(2):
        assert _REPLAY(graph) is graph.out  # the real replay, not the fixture's stand-in
    assert _launch_counts() == before


# ---- on the card ---------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph path runs only on one")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_nets(card):
    dis, ddpm = seeded_nets(3, 50, 2)
    return dis.to(card), ddpm.to(card)


def _card_enhancer(nets, batch=32):
    return Enhancer(*nets, ExperimentConfig(train=TrainConfig(batch_size=batch)),
                    device="cuda", dtype=torch.bfloat16)


@pytest.mark.card
def test_card_replay_equals_eager_at_the_rung(card_nets):
    enh = _card_enhancer(card_nets)
    wav = _wav(8, 48000, seed=1)
    first = enh.enhance_batch(wav, torch.Generator("cuda").manual_seed(4))
    replay = enh.enhance_batch(wav, torch.Generator("cuda").manual_seed(4))
    eager = enh.eager_batch(wav, torch.Generator("cuda").manual_seed(4))
    assert list(enh._graphs) == [(8, 48000)]
    assert torch.equal(first, eager)
    assert torch.equal(replay, eager)


@pytest.mark.card
def test_card_replay_at_the_batch_rows(card_nets):
    enh = _card_enhancer(card_nets)
    wav = _wav(13, 48000, seed=2)
    enh.enhance_batch(_wav(16, 48000), torch.Generator("cuda").manual_seed(1))
    x_T = _x_T(13, 5, 48000, "cuda")
    got = enh.enhance_batch(wav, x_T=x_T)
    want = enh.eager_batch(wav, x_T=x_T)
    padded = enh._graphs[(16, 48000)].forward()[:13]
    err = _rel_rms(got, want)
    print(f"13 rows replayed at 16 against eager at 13: rel RMS {err:.3e}")
    assert torch.equal(got, padded)
    assert err <= BF16_WAVE_REL_RMS


@pytest.mark.card
@pytest.mark.parametrize("change", ["load_state_dict", "in_place"])
def test_card_weight_change_recaptures(card_nets, change):
    nets = tuple(copy.deepcopy(n) for n in card_nets)
    enh = _card_enhancer(nets)
    wav, x_T = _wav(8, 48000, seed=3), _x_T(8, 6, 48000, "cuda")
    enh.enhance_batch(wav, x_T=x_T)
    before = enh.enhance_batch(wav, x_T=x_T)
    old = enh._graphs[(8, 48000)]
    with torch.no_grad():
        if change == "in_place":
            for p in enh.ddpm.parameters():
                p.mul_(1.01)
        else:
            enh.dis.load_state_dict({k: v * 1.01 if v.is_floating_point() else v
                                     for k, v in enh.dis.state_dict().items()})
    after = enh.enhance_batch(wav, x_T=x_T)
    assert enh._graphs[(8, 48000)] is not old
    replay = enh.enhance_batch(wav, x_T=x_T)
    want = enh.eager_batch(wav, x_T=x_T)
    assert not torch.equal(after, before)
    assert torch.equal(after, want) and torch.equal(replay, want)


@pytest.mark.card
def test_card_enhance_long_graphed_equals_eager(card_nets, monkeypatch):
    segment, overlap = 48000, 4800
    n = 44 * (segment - overlap) + overlap + 1000  # 45 segments: 32 + 13 rows
    wav = 0.1 * np.random.default_rng(20).standard_normal(n).astype(np.float32)
    graphed = _card_enhancer(card_nets)
    got = [enhance_long(graphed, wav, torch.Generator("cuda").manual_seed(9)) for _ in range(2)]
    assert sorted(graphed._graphs) == [(16, segment), (32, segment)]
    # eager at the same padding: the graphs' own forward on their static buffers
    eager = _card_enhancer(card_nets)
    monkeypatch.setattr(BatchGraph, "capture", BatchGraph.forward)
    monkeypatch.setattr(BatchGraph, "replay", BatchGraph.forward)
    want = enhance_long(eager, wav, torch.Generator("cuda").manual_seed(9))
    assert got[0].shape == wav.shape and np.isfinite(got[0]).all()
    assert np.array_equal(got[0], want) and np.array_equal(got[1], want)


# the hand-written kernels' demangled names in a device trace, by wrapper
KERNELS = {"stft": "stft_kernel", "istft": "istft_kernel", "enc_stage": "enc_chain_kernel",
           "enc_stage_bf16": "enc_chain_bf16_kernel"}


def _traced_kernels(call) -> list:
    """How many times the device ran each hand-written kernel in ``call``,
    from a profiler trace, in the order of :data:`WRAPPERS`."""
    import re

    from torch.autograd import DeviceType

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    return [sum(bool(re.search(rf"(^|::|\s){KERNELS[w.__name__]}[<(]", n)) for n in names)
            for w in WRAPPERS]


@pytest.mark.card
def test_card_replay_runs_the_captured_kernels(card_nets):
    enh = _card_enhancer(card_nets)
    wav = _wav(6, 48000, seed=4)
    start = _launch_counts()
    enh.enhance_batch(wav, torch.Generator("cuda").manual_seed(1))  # eager run and capture
    first = _launch_counts()
    assert [a - b for a, b in zip(first, start)] == [2, 2, 0, 70]  # the wrappers' calls
    replays = _traced_kernels(lambda: [enh.enhance_batch(wav, torch.Generator("cuda")
                                                         .manual_seed(1)) for _ in range(3)])
    assert replays == [3, 3, 0, 105]
    assert _launch_counts() == first  # a replay runs no wrapper


@pytest.mark.card
@pytest.mark.parametrize("prior", ["GCRN", "aia_complex_trans_ri"])
def test_card_other_priors_replay(card, prior):
    dis, ddpm = seeded_nets(4, 50, 2, prior=prior)
    enh = Enhancer(dis.to(card), ddpm.to(card), ExperimentConfig(), device="cuda",
                   dtype=torch.bfloat16)
    wav, x_T = _wav(5, 48000, seed=6), _x_T(5, 8, 48000, "cuda")
    enh.enhance_batch(wav, x_T=x_T)
    got = enh.enhance_batch(wav, x_T=x_T)
    padded = enh._graphs[(8, 48000)].forward()[:5]
    err = _rel_rms(got, enh.eager_batch(wav, x_T=x_T))
    print(f"{prior}: 5 rows replayed at 8 against eager at 5: rel RMS {err:.3e}")
    assert torch.equal(got, padded)
    assert err <= BF16_WAVE_REL_RMS
