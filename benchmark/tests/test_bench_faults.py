"""Each cell's check fails a broken program: the rest of a run on the CPU,
at a tiny size, with the timed path broken underneath (the harness's look
for a card skipped), for each fault of ``benchmark/harness/faults.py``.
A serving cell's run gives ``correct`` false.  A sound train run at this
size already reads above the card's limits, which were set at 64 x 48000,
so a train fault is held against a sound run of the same size instead:
some number of the check reads at least ten times the sound run's (a state
left unchanged: three times), as the limits are held against the faults
on the card (PERF.md)."""

import pytest

from benchmark.harness import core
from benchmark.harness.faults import KINDS, mutate
from conftest import SEED, SMALL

TRAIN = "diffunet.train-f32"


def run(cell, mutate=None):
    return core.run_cell(cell, SEED, 0.1, False, device="cpu",
                         traffic_overrides=SMALL[cell], mutate=mutate)


def checks(result) -> dict:
    return {k: c["value"] for k, c in result["checks"].items()}


def worst_ratio(broken: dict, sound: dict) -> float:
    return max(broken[k] / max(sound[k], 1e-30) for k in sound)


SERVING = ("diffunet.files-f32", "dbaiat.files-f32", "diffunet.recordings-bf16")


@pytest.mark.parametrize("cell", SERVING)
def test_sound_serving_run_is_correct(cell):
    assert run(cell)["correct"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cell", SERVING)
def test_serving_fault_is_caught(cell, kind):
    r = run(cell, mutate(kind, core.load_cell(cell).limits))
    assert not r["correct"], r["checks"]


@pytest.fixture(scope="module")
def sound_train():
    return checks(run(TRAIN))


@pytest.mark.parametrize("kind", KINDS)
def test_train_fault_is_caught(kind, sound_train):
    broken = checks(run(TRAIN, mutate(kind, core.load_cell(TRAIN).limits)))
    need = 3 if kind == "state_unchanged" else 10
    assert worst_ratio(broken, sound_train) >= need, (broken, sound_train)


def test_a_fault_after_the_checked_steps_is_caught_past_the_window(sound_train):
    """A path that switches on once set-up is over (the window's steps,
    here each on half its rows) is seen by the step the check samples
    after the window."""
    def half_after_setup(driver):
        tr = driver.trainer
        step = tr._train_step

        def step_k(noisy, clean, frames, draws=None, norms=True):
            if driver.steps < 3:
                return step(noisy, clean, frames, draws=draws, norms=norms)
            h = noisy.shape[0] // 2
            return step(noisy[:h], clean[:h], frames[:h],
                        draws=type(draws)(draws.idx[:h], draws.normal[:h]), norms=norms)
        tr._train_step = step_k

    broken = checks(run(TRAIN, half_after_setup))
    late = {k: v for k, v in sound_train.items() if k.startswith("late_")}
    early = {k: v for k, v in sound_train.items() if k not in late}
    assert worst_ratio(broken, late) >= 10, (broken, sound_train)
    assert worst_ratio(broken, early) < 10, (broken, sound_train)  # they saw no fault
