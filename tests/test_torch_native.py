"""The port's native train loader against the JAX package's (CPU).

* ``runtime/wav_runtime.cpp`` is the JAX package's file byte for byte, so
  the port's build is the reference's own code;
* ``decode_wav``, ``wav_info`` and ``load_batch`` return what JAX's return;
* ``TrainLoader`` (native by default, as JAX's) gives bit for bit the
  batches of JAX's default loader for one seed over two epochs, on a
  corpus with an utterance shorter than the chunk, one exactly the chunk
  and five longer; and on a corpus holding a file the native decoder
  refuses (8 kHz), both fall back to the Python path from that batch on,
  with the same batches;
* the native crops are ``start % (len - chunk + 1)`` of one draw of
  ``integers(0, 2**62)`` a batch: the batches equal
  ``chip_smoke.native_batch_np``'s numpy re-derivation, which phase 11
  holds the card machine's build to.
"""

import os

import numpy as np
import pytest

import chip_smoke
from prior_diffuse_tpu import runtime as jrt
from prior_diffuse_tpu.data import dataset as jds
from prior_diffuse_tpu_torch.data import dataset as tds
from prior_diffuse_tpu_torch.data import synthetic as tsyn
from prior_diffuse_tpu_torch.data.wavio import read_wav, write_wav
from prior_diffuse_tpu_torch.runtime import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 4000
FIELDS = ("noisy", "clean", "frame_nums", "wav_lens", "scales")


def _corpus(root, bad_name=None):
    """7 train pairs of 0.25-0.5 s; ``str_001`` cut to CHUNK - 700 samples,
    ``str_002`` to exactly CHUNK; ``str_005`` is all silence (noisy and
    clean zeros: the generator scales its noise to a silent clean signal);
    ``bad_name``'s noisy file rewritten at 8 kHz (the Python path resamples
    it, the native runtime refuses it)."""
    tsyn.write_corpus_speechlike(root, n_train=7, n_test=2, min_len=CHUNK + 1,
                                 max_len=2 * CHUNK, seed=5)
    for name, n in (("str_001.wav", CHUNK - 700), ("str_002.wav", CHUNK)):
        for side in ("noisy", "clean"):
            path = os.path.join(root, f"{side}_trainset_wav", name)
            write_wav(path, read_wav(path)[0][:n])
    if bad_name:
        path = os.path.join(root, "noisy_trainset_wav", bad_name)
        write_wav(path, read_wav(path)[0][::2], sr=8000)
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(str(tmp_path_factory.mktemp("native")))


def _datasets(root):
    return [mod.PairedWavDataset(f"{root}/noisy_trainset_wav", f"{root}/clean_trainset_wav",
                                 chunk_length=CHUNK) for mod in (tds, jds)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_runtime_source_is_the_jax_packages():
    with open(os.path.join(ROOT, "prior_diffuse_tpu", "runtime", "wav_runtime.cpp"), "rb") as a, \
            open(os.path.join(ROOT, "prior_diffuse_tpu_torch", "runtime", "wav_runtime.cpp"),
                 "rb") as b:
        assert a.read() == b.read()


def test_builds_into_the_package_build_dir():
    assert native.available() and jrt.available()
    so = native.library_path()
    assert so.exists() and so.parent.name == "build"
    assert so.parent.parent.name == "prior_diffuse_tpu_torch"


def test_decode_and_info_equal_jax(corpus):
    for name in ("str_000.wav", "str_001.wav"):
        path = os.path.join(corpus, "noisy_trainset_wav", name)
        got, want = native.decode_wav(path), jrt.decode_wav(path)
        assert got[1] == want[1] == 16000
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[0], read_wav(path, None)[0])
        assert native.wav_info(path) == jrt.wav_info(path) == (len(got[0]), 16000)
    assert native.decode_wav(os.path.join(corpus, "missing.wav")) is None


def test_load_batch_equals_jax(corpus):
    ds, _ = _datasets(corpus)
    noisy = [os.path.join(ds.noisy_root, n) for n in ds.names]
    clean = [os.path.join(ds.clean_root, n) for n in ds.names]
    starts = np.random.default_rng(0).integers(0, 2**62, size=len(noisy))
    got = native.load_batch(noisy, clean, CHUNK, starts, num_threads=2)
    want = jrt.load_batch(noisy, clean, CHUNK, starts, num_threads=2)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    silent = ds.names.index("str_005.wav")  # an all-zero crop keeps the scale 1
    assert got[4][silent] == 1 and not got[0][silent].any()
    with pytest.raises(ValueError, match="crop starts"):
        native.load_batch(noisy, clean, CHUNK, starts[:2], num_threads=2)


def test_default_loader_equals_jax_default_over_two_epochs(corpus):
    t_ds, j_ds = _datasets(corpus)
    t_loader, j_loader = tds.TrainLoader(t_ds, 3, seed=4), jds.TrainLoader(j_ds, 3, seed=4)
    assert t_loader.native and j_loader.native and len(t_loader) == 2
    rng = np.random.default_rng(4)
    lens = [min(len(read_wav(os.path.join(r, n))[0]) for r in (t_ds.noisy_root, t_ds.clean_root))
            for n in t_ds.names]
    assert min(lens) < CHUNK and CHUNK in lens and sum(n > CHUNK for n in lens) == 5
    for _ in range(2):  # the permutation and the crop draws go on across epochs
        got = list(t_loader)
        _assert_batches_equal(got, list(j_loader))
        order = rng.permutation(len(t_ds))
        want = [chip_smoke.native_batch_np(t_ds, order[k * 3:(k + 1) * 3],
                                           rng.integers(0, 2**62, size=3)) for k in range(2)]
        _assert_batches_equal(got, want)
    assert t_loader.native_batches == 4


def test_python_path_is_not_the_native_one(corpus):
    """The two paths crop other windows from one seed, so the test above
    tells them apart (the silent pair is NaN on the Python path, which
    divides by its zero energy)."""
    t_ds, _ = _datasets(corpus)
    nat = list(tds.TrainLoader(t_ds, 3, seed=4))
    py = list(tds.TrainLoader(t_ds, 3, seed=4, native=False))
    finite = [(a.noisy[i], b.noisy[i]) for a, b in zip(nat, py) for i in range(3)
              if np.isfinite(b.noisy[i]).all()]
    assert len(finite) >= 5 and any(not np.array_equal(a, b) for a, b in finite)


# the refused file lands in the first epoch's batch 0 (seed 0) or 1 (seed 1)
@pytest.mark.parametrize("seed,served", [(0, 0), (1, 1)])
def test_refused_file_falls_back_as_jax(tmp_path, seed, served):
    root = _corpus(str(tmp_path), bad_name="str_004.wav")
    t_ds, j_ds = _datasets(root)
    assert t_ds.names.index("str_004.wav") in np.random.default_rng(seed).permutation(7)[
        3 * served:3 * served + 3]
    t_loader, j_loader = tds.TrainLoader(t_ds, 3, seed=seed), jds.TrainLoader(j_ds, 3, seed=seed)
    _assert_batches_equal(list(t_loader), list(j_loader))
    assert t_loader.native_batches == served  # native until that batch, Python from it on
    _assert_batches_equal(list(t_loader), list(j_loader))
