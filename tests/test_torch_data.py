"""The port's data pipeline against the JAX package (CPU).

WAV I/O and the synthetic corpora are copies and must give the same files
and samples; the loaders must give exactly the same batches (noisy, clean,
frame counts, lengths, RMS scales) as JAX's.  Here both ``TrainLoader``s
take their Python path (``native=False``); ``tests/test_torch_native.py``
holds the default native path and its fallback to JAX's.
"""

import os

import numpy as np
import pytest

from prior_diffuse_tpu.data import dataset as jds
from prior_diffuse_tpu.data import synthetic as jsyn
from prior_diffuse_tpu.data import wavio as jwavio
from prior_diffuse_tpu_torch.data import dataset as tds
from prior_diffuse_tpu_torch.data import synthetic as tsyn
from prior_diffuse_tpu_torch.data import wavio as twavio

FIELDS = ("noisy", "clean", "frame_nums", "wav_lens", "scales")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same speech-like corpus written by both packages (7 train
    utterances of 0.4-0.9 s, 5 test)."""
    roots = {}
    for name, syn in (("jax", jsyn), ("torch", tsyn)):
        root = str(tmp_path_factory.mktemp(name))
        syn.write_corpus_speechlike(root, n_train=7, n_test=5, min_len=6400,
                                    max_len=14400, seed=3)
        roots[name] = root
    return roots


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_synthetic_corpora_are_byte_equal(corpora):
    names = _files(corpora["jax"])
    assert names == _files(corpora["torch"]) and len(names) == 24
    for name in names:
        with open(os.path.join(corpora["jax"], name), "rb") as a, \
                open(os.path.join(corpora["torch"], name), "rb") as b:
            assert a.read() == b.read(), name


def test_write_corpus_is_byte_equal(tmp_path):
    jsyn.write_corpus(str(tmp_path / "j"), n_train=2, n_test=1, min_len=2000, max_len=3000)
    tsyn.write_corpus(str(tmp_path / "t"), n_train=2, n_test=1, min_len=2000, max_len=3000)
    for name in _files(str(tmp_path / "j")):
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes()


@pytest.mark.parametrize("sr", [16000, 8000, None])
def test_read_wav_equals_jax(corpora, sr):
    path = os.path.join(corpora["torch"], "noisy_trainset_wav", "str_000.wav")
    got, got_sr = twavio.read_wav(path, sr)
    want, want_sr = jwavio.read_wav(path, sr)
    assert got_sr == want_sr
    np.testing.assert_array_equal(got, want)


def test_write_wav_round_trip_equals_jax(tmp_path, rng):
    x = np.clip(0.5 * rng.standard_normal(3001), -1.2, 1.2).astype(np.float32)
    twavio.write_wav(str(tmp_path / "t.wav"), x)
    jwavio.write_wav(str(tmp_path / "j.wav"), x)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


def _datasets(root, chunk):
    out = []
    for mod in (tds, jds):
        out.append([mod.PairedWavDataset(f"{root}/noisy_{s}_wav", f"{root}/clean_{s}_wav",
                                         chunk_length=chunk)
                    for s in ("trainset", "testset")])
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_train_batches_equal_jax_python_loader(corpora):
    (t_tr, _), (j_tr, _) = _datasets(corpora["torch"], 8000)
    t_loader = tds.TrainLoader(t_tr, 3, seed=9, native=False)
    j_loader = jds.TrainLoader(j_tr, 3, seed=9, native=False)
    assert len(t_loader) == len(j_loader) == 2
    for _ in range(2):  # two epochs: the permutation and crop stream go on
        _assert_batches_equal(list(t_loader), list(j_loader))


@pytest.mark.parametrize("drop_last", [True, False])
def test_eval_batches_equal_jax(corpora, drop_last):
    (_, t_cv), (_, j_cv) = _datasets(corpora["torch"], 8000)
    got = list(tds.EvalLoader(t_cv, 2, drop_last=drop_last))
    want = list(jds.EvalLoader(j_cv, 2, drop_last=drop_last))
    assert len(got) == (2 if drop_last else 3)
    _assert_batches_equal(got, want)
    # padded to a multiple of the 16000-sample bucket, masks past the end
    for b in got:
        assert b.noisy.shape[1] % 16000 == 0
        assert (b.frame_nums == b.wav_lens // 160 + 1).all()


def test_short_utterance_is_not_cropped(corpora):
    (t_tr, _), (j_tr, _) = _datasets(corpora["torch"], 48000)
    got = t_tr.load_pair(0, crop=True, rng=np.random.default_rng(0))
    want = j_tr.load_pair(0, crop=True, rng=np.random.default_rng(0))
    assert got[2:] == want[2:] and got[3] < 48000
    np.testing.assert_array_equal(got[0], want[0])


def test_loader_errors_reach_the_consumer(tmp_path):
    """A file that fails to load raises in the loop that reads the batches
    (not only in the prefetch thread)."""
    tsyn.write_corpus(str(tmp_path), n_train=2, n_test=1, min_len=2000, max_len=3000)
    ds = tds.PairedWavDataset(f"{tmp_path}/noisy_trainset_wav",
                              f"{tmp_path}/clean_trainset_wav", chunk_length=1600)
    os.remove(os.path.join(ds.clean_root, ds.names[1]))
    with pytest.raises(FileNotFoundError):
        list(tds.TrainLoader(ds, 2))


def test_empty_split_raises(tmp_path):
    (tmp_path / "n").mkdir()
    with pytest.raises(FileNotFoundError):
        tds.PairedWavDataset(str(tmp_path / "n"), str(tmp_path / "c"))
