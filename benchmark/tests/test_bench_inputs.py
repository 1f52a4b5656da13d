"""Inputs made from the seed repeat, and every seed gets the same sizes."""

import numpy as np
import pytest
import torch

from benchmark.harness import inputs
from benchmark.reference import models as ref

CPU = torch.device("cpu")
FILES = {"kind": "lognormal", "median_s": 3.0, "sigma": 0.5, "min_s": 1.0, "max_s": 10.0}


def test_lengths_are_the_distributions_quantiles():
    a = inputs.quantile_lengths(256, FILES)
    assert a.min() == 16000 and a.max() <= 160000
    assert abs(np.median(a) / 16000 - 3.0) < 0.05
    u = inputs.quantile_lengths(48, {"kind": "uniform", "min_s": 40.0, "max_s": 120.0})
    assert 40 * 16000 < u.min() < u.max() < 120 * 16000


def test_pool_repeats_for_a_seed_and_keeps_its_lengths():
    lengths = inputs.quantile_lengths(6, {"kind": "uniform", "min_s": 0.1, "max_s": 0.3})
    a = inputs.signal_pool(lengths, 2 ** 40 + 3, CPU, 3)
    b = inputs.signal_pool(lengths, 2 ** 40 + 3, CPU, 3)
    c = inputs.signal_pool(lengths, 7, CPU, 3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert list(map(len, a)) == list(map(len, c)) == lengths.tolist()
    assert all(not np.array_equal(x[:1000], y[:1000]) for x, y in zip(a, c))


@pytest.mark.parametrize("n,strata", [(256, 64), (48, 8)])
def test_stratified_order_gives_every_block_the_same_mix(n, strata):
    lengths = inputs.quantile_lengths(n, FILES)
    rank = np.argsort(np.argsort(lengths, kind="stable"), kind="stable") // (n // strata)
    orders = [inputs.stratified_order(lengths, strata, seed, 3) for seed in (1, 2, 2 ** 40)]
    for order in orders:
        assert sorted(order.tolist()) == list(range(n))
        for block in order.reshape(-1, strata):
            assert sorted(rank[block].tolist()) == list(range(strata))
    assert not np.array_equal(orders[0], orders[1])
    assert np.array_equal(orders[1], inputs.stratified_order(lengths, strata, 2, 3))


def test_weights_repeat_for_a_seed():
    a = inputs.seeded_state(ref.DiffUNet(), 2 ** 35, CPU, 1)
    b = inputs.seeded_state(ref.DiffUNet(), 2 ** 35, CPU, 1)
    c = inputs.seeded_state(ref.DiffUNet(), 2 ** 35 + 1, CPU, 1)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["core.en.conv1.l.weight"], c["core.en.conv1.l.weight"])
    bound = (32 * 2 * 5) ** -0.5
    assert a["core.en.conv1.l.weight"].abs().max() <= bound
    var = a["core.en.bn1.running_var"]
    assert 0.5 <= var.min() and var.max() <= 1.5


def test_noisy_speech_repeats():
    g1, g2 = inputs.generator(5, CPU, 5), inputs.generator(5, CPU, 5)
    n1, c1 = inputs.noisy_speech(2, 4800, g1, CPU)
    n2, c2 = inputs.noisy_speech(2, 4800, g2, CPU)
    assert torch.equal(n1, n2) and torch.equal(c1, c2)
    assert torch.allclose(c1.pow(2).mean(1), torch.ones(2), rtol=1e-4)


def test_derived_seeds_take_large_seeds():
    assert inputs.derived_seed(2 ** 40 + 1, 3) != inputs.derived_seed(2 ** 40 + 2, 3)
    assert 0 <= inputs.derived_seed(2 ** 62, 1) < 2 ** 63
