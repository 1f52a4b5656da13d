"""Each cell's control fails its check: the reference one precision below
the cell's (TF32 for the float32 cells, computed in e4m3 for the bf16
cell), put in the program's place.  On the card (``card``): the serving
cells at a small size, the train cell at its own; the e4m3 control also on
the CPU at a tiny size.  The full-size readings the limits were set from
are in PERF.md (``benchmark/calibrate.py``)."""

import pytest

from benchmark.calibrate import readings
from benchmark.harness import core
from conftest import SEED, SMALL

CONTROL = {"diffunet.files-f32": "tf32", "dbaiat.files-f32": "tf32",
           "diffunet.recordings-bf16": "fp8", "diffunet.train-f32": "tf32"}
CARD_SIZE = {
    "diffunet.files-f32": dict(SMALL["diffunet.files-f32"], batch_size=4, per_call=8, pool=16,
                               bucket_samples=16000,
                               lengths={"kind": "uniform", "min_s": 1.0, "max_s": 3.0}),
    "diffunet.recordings-bf16": dict(SMALL["diffunet.recordings-bf16"], segment=48000,
                                     overlap=4800, batch_size=8,
                                     lengths={"kind": "uniform", "min_s": 8.0, "max_s": 12.0}),
    "diffunet.train-f32": {},  # its own size: 64 x 48000
}
CARD_SIZE["dbaiat.files-f32"] = dict(CARD_SIZE["diffunet.files-f32"], reference_rows=1)


def failed(values: dict, limits: dict) -> bool:
    return any(values[k] > limits[k] for k in limits)


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_control_fails_on_the_card(card, cell):
    limits = core.load_cell(cell).limits
    for seed in (SEED, SEED + 1, SEED + 2):
        r = readings(cell, seed, 0.5, CONTROL[cell], traffic_overrides=CARD_SIZE[cell])
        assert not failed(r["program"], limits), r
        assert failed({k: v for k, v in r["control"].items() if k in limits}, limits), r


def test_e4m3_control_reads_far_above_the_bf16_program_on_the_cpu():
    cell = "diffunet.recordings-bf16"
    r = readings(cell, SEED, 0.1, "fp8", device="cpu", traffic_overrides=SMALL[cell])
    assert r["control"]["wav_rel_err"] > 3 * r["program"]["wav_rel_err"]
