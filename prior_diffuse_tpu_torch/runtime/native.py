"""ctypes bindings for the native data-plane runtime.

The counterpart of ``prior_diffuse_tpu/runtime/native.py`` on this
package's own copy of ``wav_runtime.cpp`` (held byte for byte equal to the
JAX package's by ``tests/test_torch_native.py``).  One ``g++ -O3``
invocation builds ``libpdt_runtime-<hash>.so`` at first use, never at
import, into the git-ignored ``build/`` directory of this package; the
hash covers the source and the flags, so an edited source is rebuilt.  It
exposes:

* :func:`decode_wav` — single-file decode;
* :func:`wav_info` — ``(samples, sample_rate)`` of a file;
* :func:`load_batch` — the training hot loop (decode pair + crop + RMS
  normalise + pad) across a worker thread pool, one call per batch.

As in the JAX package, a failed build or load logs a warning and
:func:`available` is False; :func:`load_batch` then returns None and
``data.dataset.TrainLoader`` takes the Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "wav_runtime.cpp"
BUILD_DIR = _SRC.parent.parent / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lock = threading.Lock()
_build_failed = False


def library_path() -> Path:
    """Where the build of this source with these flags goes."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"libpdt_runtime-{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: a concurrent build never loads a partial file
        return True
    except (OSError, subprocess.SubprocessError) as e:
        logging.warning("native runtime build failed: %s", e)
        tmp.unlink(missing_ok=True)
        return False


def _get_lib():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = library_path()
        if not so.exists() and not _build(so):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            logging.warning("native runtime load failed: %s", e)
            _build_failed = True
            return None
        lib.pdt_decode_wav.restype = ctypes.c_long
        lib.pdt_decode_wav.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_long, ctypes.POINTER(ctypes.c_int),
        ]
        lib.pdt_wav_info.restype = ctypes.c_long
        lib.pdt_wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.pdt_load_batch.restype = ctypes.c_int
        lib.pdt_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_long, ctypes.POINTER(ctypes.c_long),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _get_lib() is not None


def wav_info(path: str) -> Optional[Tuple[int, int]]:
    """-> (num_samples, sample_rate) without decoding to Python."""
    lib = _get_lib()
    if lib is None:
        return None
    sr = ctypes.c_int(0)
    n = lib.pdt_wav_info(path.encode(), ctypes.byref(sr))
    if n < 0:
        return None
    return int(n), int(sr.value)


def decode_wav(path: str, max_len: int = 16000 * 60) -> Optional[Tuple[np.ndarray, int]]:
    lib = _get_lib()
    if lib is None:
        return None
    out = np.empty(max_len, np.float32)
    sr = ctypes.c_int(0)
    n = lib.pdt_decode_wav(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_len, ctypes.byref(sr),
    )
    if n < 0:
        return None
    return out[:n].copy(), int(sr.value)


def load_batch(
    noisy_paths: Sequence[str],
    clean_paths: Sequence[str],
    chunk: int,
    crop_starts: Sequence[int],
    win_size: int = 320,
    fft_num: int = 320,
    win_shift: int = 160,
    sample_rate: int = 16000,
    num_threads: int = 0,
):
    """Native paired-batch load; returns (noisy, clean, frame_nums,
    wav_lens, scales) or None when the native path can't serve it.  Each
    utterance longer than ``chunk`` is cropped at ``crop_starts[i] % (len -
    chunk + 1)``; the scales are float32 ``sqrt(len / energy)`` from a
    double energy (1 for an all-zero crop)."""
    lib = _get_lib()
    if lib is None:
        return None
    n = len(noisy_paths)
    if len(clean_paths) != n or len(crop_starts) != n:
        raise ValueError(f"{n} noisy paths, {len(clean_paths)} clean, "
                         f"{len(crop_starts)} crop starts")
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    noisy = np.zeros((n, chunk), np.float32)
    clean = np.zeros((n, chunk), np.float32)
    frames = np.zeros(n, np.int32)
    lens = np.zeros(n, np.int32)
    scales = np.zeros(n, np.float32)
    np_arr = (ctypes.c_char_p * n)(*[p.encode() for p in noisy_paths])
    cp_arr = (ctypes.c_char_p * n)(*[p.encode() for p in clean_paths])
    starts = np.ascontiguousarray(crop_starts, np.int64)
    rc = lib.pdt_load_batch(
        np_arr, cp_arr, n, chunk,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        win_size, fft_num, win_shift, sample_rate, num_threads,
        noisy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        clean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        return None  # some file unsupported: caller falls back to Python
    return noisy, clean, frames, lens, scales
