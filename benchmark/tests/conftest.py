"""The benchmark's CPU tests; those marked ``card`` run only where a CUDA
device is present (``python -m pytest benchmark/tests -q -m card`` on the
card machine) and skip here with a reason."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card machine)")
    return torch.device("cuda")


# tiny traffic for CPU runs of each cell: the same drivers, files and
# checks at sizes a test run holds
SMALL = {
    "diffunet.files-f32": {
        "pool": 8, "per_call": 4, "batch_size": 2, "bucket_samples": 1600,
        "lengths": {"kind": "lognormal", "median_s": 0.25, "sigma": 0.5, "min_s": 0.15,
                    "max_s": 0.5},
        "check_calls": 2, "reference_rows": 2},
    "diffunet.recordings-bf16": {
        "pool": 2, "strata": 2, "lengths": {"kind": "uniform", "min_s": 0.8, "max_s": 1.2},
        "segment": 4800, "overlap": 480, "batch_size": 4, "check_calls": 2,
        "reference_rows": 2},
    "diffunet.train-f32": {"rows": 2, "length": 4800, "batches": 4},
}
SMALL["dbaiat.files-f32"] = SMALL["diffunet.files-f32"]
SEED = 2 ** 33 + 17


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)
