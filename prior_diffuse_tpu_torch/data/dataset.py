"""Host-side data pipeline.

The counterpart of ``prior_diffuse_tpu/data/dataset.py`` (numpy only):

* datasets pair noisy/clean wavs by shared filename under
  ``data/{noisy,clean}_{trainset,testset}_wav`` and random-crop training
  utterances to ``chunk_length`` samples;
* batches are RMS-normalised by the *noisy* factor and fixed-shape: train
  batches exactly ``chunk_length``, eval batches padded to a multiple of
  ``bucket_samples``; the STFT runs in the train/eval step on the device;
* a background thread prefetches batches while the device computes.

``TrainLoader`` is the JAX loader, both paths: by default the native
C++ runtime (``runtime/native.py``) decodes, crops and normalises a batch
in one call, with one draw of crop starts a batch
(``rng.integers(0, 2**62)``, cropped at ``start % (len - chunk + 1)``);
the Python path (``native=False``, and the fallback for the rest of an
epoch once the native runtime cannot serve a batch) draws each crop in
:meth:`PairedWavDataset.load_pair`.  From one seed either path gives the
batches of the JAX loader's same path.

Data parallelism: ``TrainLoader(shard=(rank, world))`` gives one rank its
rows of each global batch of ``batch_size`` (the batch padded with zero
rows, ``frame_nums`` 0, to a multiple of ``world``; rank ``r`` the ``r``-th
contiguous share, ``parallel.mesh.shard_rows``).  Every rank draws the
global permutation and crops from the shared seed, so the ranks' rows
concatenated are the single-process batch bit for bit; the native runtime
loads only this rank's files.  ``PairedWavDataset(shard=)`` is the JAX
package's per-host split of the corpus by name.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from prior_diffuse_tpu_torch.data.wavio import read_wav
from prior_diffuse_tpu_torch.parallel.mesh import shard_rows
from prior_diffuse_tpu_torch.signal.stft import frame_count


@dataclass
class Batch:
    """Fixed-shape host batch of normalized waveforms."""

    noisy: np.ndarray  # [B, L] float32, RMS-normalized
    clean: np.ndarray  # [B, L]
    frame_nums: np.ndarray  # [B] int32 — valid frames (pre-padding)
    wav_lens: np.ndarray  # [B] int32 — valid samples (pre-padding)
    scales: np.ndarray  # [B] float32 — the RMS factors applied


class PairedWavDataset:
    """Noisy/clean wav pairs matched by filename."""

    def __init__(
        self,
        noisy_root: str,
        clean_root: str,
        chunk_length: int = 48000,
        win_size: int = 320,
        fft_num: int = 320,
        win_shift: int = 160,
        sample_rate: int = 16000,
        shard: Optional[Tuple[int, int]] = None,
    ):
        """``shard=(index, count)`` keeps every ``index``-th of ``count``
        names (JAX ``dataset.py:54-72``'s per-host split)."""
        self.noisy_root = noisy_root
        self.clean_root = clean_root
        self.chunk_length = chunk_length
        self.win_size = win_size
        self.fft_num = fft_num
        self.win_shift = win_shift
        self.sample_rate = sample_rate
        self.names = sorted(
            os.path.basename(p) for p in glob.glob(os.path.join(noisy_root, "*.wav"))
        )
        if shard is not None and shard[1] > 1:
            index, count = shard
            self.names = self.names[index::count]
        if not self.names:
            raise FileNotFoundError(f"no wavs under {noisy_root}")

    def __len__(self) -> int:
        return len(self.names)

    def load_pair(
        self, index: int, crop: bool, rng: Optional[np.random.Generator] = None
    ) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """-> (noisy, clean, frame_num, wav_len); random-crops if asked."""
        name = self.names[index]
        noisy, _ = read_wav(os.path.join(self.noisy_root, name), self.sample_rate)
        clean, _ = read_wav(os.path.join(self.clean_root, name), self.sample_rate)
        n = min(len(noisy), len(clean))
        noisy, clean = noisy[:n], clean[:n]
        if crop and n > self.chunk_length:
            start = int((rng or np.random.default_rng()).integers(0, n - self.chunk_length + 1))
            noisy = noisy[start : start + self.chunk_length]
            clean = clean[start : start + self.chunk_length]
            n = self.chunk_length
        fn = frame_count(n, self.win_size, self.fft_num, self.win_shift)
        return noisy, clean, fn, n


def _rms_normalize_pair(noisy, clean):
    c = np.sqrt(len(noisy) / np.sum(noisy.astype(np.float64) ** 2))
    return (noisy * c).astype(np.float32), (clean * c).astype(np.float32), np.float32(c)


def _collate(
    items: Sequence[Tuple[np.ndarray, np.ndarray, int, int]], pad_to: int
) -> Batch:
    b = len(items)
    noisy = np.zeros((b, pad_to), np.float32)
    clean = np.zeros((b, pad_to), np.float32)
    frames = np.zeros((b,), np.int32)
    lens = np.zeros((b,), np.int32)
    scales = np.zeros((b,), np.float32)
    for i, (nz, cl, fn, wl) in enumerate(items):
        nz, cl, c = _rms_normalize_pair(nz, cl)
        noisy[i, : len(nz)] = nz
        clean[i, : len(cl)] = cl
        frames[i], lens[i], scales[i] = fn, wl, c
    return Batch(noisy, clean, frames, lens, scales)


class _Prefetcher:
    """Runs a batch-producing generator in a daemon thread."""

    def __init__(self, gen_fn, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._gen_fn = gen_fn
        self._thread = None

    def __iter__(self):
        sentinel = object()
        error = []

        def work():
            try:
                for item in self._gen_fn():
                    self._q.put(item)
            except Exception as e:  # a failed read: re-raised in the consumer
                error.append(e)
            finally:
                self._q.put(sentinel)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        while True:
            item = self._q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item


def _arrays(batch: Batch) -> tuple:
    return batch.noisy, batch.clean, batch.frame_nums, batch.wav_lens, batch.scales


def _pad_rows(batch: Batch, rows: int) -> Batch:
    """``batch`` followed by zero rows (``frame_nums`` 0) up to ``rows``."""
    return Batch(*(np.concatenate([a, np.zeros((rows - len(a), *a.shape[1:]), a.dtype)])
                   for a in _arrays(batch)))


class TrainLoader:
    """Shuffled fixed-chunk training batches (drop_last=True).

    Uses the native C++ runtime (decode+crop+normalize across a thread
    pool, ``prior_diffuse_tpu_torch.runtime``) when it can serve the
    corpus; otherwise the pure-Python path.  ``native_batches`` counts the
    batches the native runtime served.  With ``shard=(rank, world)`` each
    batch is this rank's rows of the global batch of ``batch_size`` (the
    module docstring): the native runtime loads this rank's files with
    their share of the global crop starts; the Python path loads the whole
    batch, since its crop draws follow each file's length, and keeps this
    rank's rows.  A batch the native runtime refuses while it is available
    raises there: the other ranks cannot see that this one fell back.
    """

    def __init__(
        self,
        dataset: PairedWavDataset,
        batch_size: int,
        seed: int = 1234,
        prefetch: int = 2,
        native: bool = True,
        shard: Tuple[int, int] = (0, 1),
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.native = native
        self.shard = shard
        self.native_batches = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _native_batch(self, idx) -> Optional[Batch]:
        """This rank's rows of the global batch ``idx`` through the native
        runtime, or None where it cannot serve them."""
        from prior_diffuse_tpu_torch.runtime import native

        ds = self.dataset
        # drawn before the call, for the global batch: a batch the runtime
        # refuses still takes them
        starts = self.rng.integers(0, 2**62, size=len(idx))
        mine = shard_rows(np.arange(1, len(idx) + 1), *self.shard)  # 0: a pad row
        real = mine[mine > 0] - 1
        out = native.load_batch(
            [os.path.join(ds.noisy_root, ds.names[j]) for j in idx[real]],
            [os.path.join(ds.clean_root, ds.names[j]) for j in idx[real]],
            ds.chunk_length, starts[real],
            ds.win_size, ds.fft_num, ds.win_shift, ds.sample_rate,
        ) if len(real) else _arrays(_collate([], ds.chunk_length))
        if out is None:
            if self.shard[1] > 1 and native.available():
                raise RuntimeError(
                    "the native runtime refused a file of this rank's rows; under data "
                    "parallelism every rank must take the same path: convert the corpus "
                    f"to {ds.sample_rate} Hz PCM or use TrainLoader(native=False)")
            return None
        self.native_batches += 1
        return _pad_rows(Batch(*out), len(mine))

    def __iter__(self) -> Iterator[Batch]:
        order = self.rng.permutation(len(self.dataset))
        bs = self.batch_size
        use_native = self.native

        def gen():
            nonlocal use_native
            for i in range(len(self)):
                idx = order[i * bs : (i + 1) * bs]
                if use_native:
                    batch = self._native_batch(idx)
                    if batch is not None:
                        yield batch
                        continue
                    use_native = False  # fall back for the whole epoch
                items = [
                    self.dataset.load_pair(j, crop=True, rng=self.rng) for j in idx
                ]
                batch = _collate(items, self.dataset.chunk_length)
                yield Batch(*(shard_rows(a, *self.shard) for a in _arrays(batch)))

        return iter(_Prefetcher(gen, self.prefetch))


class EvalLoader:
    """Full-length eval batches padded to a length bucket.

    Batches are formed from length-sorted utterances (by file size) and
    padded to a multiple of ``bucket_samples``, which bounds the set of
    batch shapes."""

    def __init__(
        self,
        dataset: PairedWavDataset,
        batch_size: int,
        bucket_samples: int = 16000,
        drop_last: bool = False,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.bucket = bucket_samples
        self.drop_last = drop_last
        self.prefetch = prefetch
        # one cheap metadata pass: wav byte length ~ duration ordering
        self._sizes = [
            os.path.getsize(os.path.join(dataset.noisy_root, n))
            for n in dataset.names
        ]
        self._order = np.argsort(self._sizes)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        bs = self.batch_size

        def gen():
            for i in range(len(self)):
                idx = self._order[i * bs : (i + 1) * bs]
                items = [self.dataset.load_pair(j, crop=False) for j in idx]
                longest = max(it[3] for it in items)
                pad_to = -(-longest // self.bucket) * self.bucket
                yield _collate(items, pad_to)

        return iter(_Prefetcher(gen, self.prefetch))
