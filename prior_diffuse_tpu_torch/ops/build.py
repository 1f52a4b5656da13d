"""Build and load the CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all started together, and links the objects into one shared
library with a plain C interface, at first use, into the git-ignored
``build/`` directory of this package; ``ctypes`` loads it.  The file name
carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is not.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argument types (all return a cudaError_t as int)
_SIGNATURES = {
    "pdt_stft_f32": [_P, _P, _P, _I, _I, _I, _P],
    "pdt_istft_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "pdt_enc_stage_f32": [_P] * 9 + [_I] * 9 + [_P],
    "pdt_enc_stage_bf16": [_P] * 8 + [_I] * 10 + [_P],
}


@dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # compile time, 0.0 when the library was already built
    log: str        # nvcc / ptxas output of the compile


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH)")


def build() -> Build:
    """Compile ``csrc/*.cu`` unless this exact source set is built already."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    lib = BUILD_DIR / f"libpdt_kernels-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return Build(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{src.stem}.{os.getpid()}.o") for src in sources]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [(src.name, p.returncode, out) for src, p, out in zip(sources, procs, logs)
              if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(("link", link.returncode, logs[-1]))
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"[{name}: exit {rc}]\n{out}" for name, rc, out in failed))
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return Build(lib, seconds, "".join(logs))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pdt_error_string.argtypes = [ctypes.c_int]
    lib.pdt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        msg = library().pdt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
