"""Build, load and count the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface and loaded with ctypes; no PyTorch headers
are involved, so a build takes seconds. Libraries are built at first use
from the sources in this package into `_build/` (listed in .gitignore),
keyed by a hash of the source so an edited kernel is rebuilt. `build_all`
starts one `nvcc` per source at once.

Every kernel wrapper adds one to `LAUNCHES[name]` where it launches its
kernel, and nowhere else, so a run can show that its path went through the
kernels (`reset_launches` before, read after).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

SOURCES = {"histogram": "histogram.cu", "attention": "attention.cu",
           "attention_bwd": "attention_bwd.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

LAUNCHES: Dict[str, int] = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_STRIDES = [_L, _L, _L]  # batch, head, row (csrc/attention_common.cuh)
# C signatures of the exported launchers (all return a cudaError_t as int)
_SIGNATURES = {
    "histogram": {
        "event_histogram": [_P] + [_I] * 9 + [_P, _P],
    },
    "attention": {
        "attention_fwd": [_P] * 5 + [_I] * 4 + _STRIDES * 2 + [_I, _F, _P],
    },
    "attention_bwd": {
        "attention_bwd": [_P] * 9 + [_I] * 4 + _STRIDES * 2 + [_I, _F, _P],
    },
}


def reset_launches() -> None:
    LAUNCHES.clear()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    """The library's path, keyed by its source, every shared header in
    csrc/ and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start_build(name: str):
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, tmp, out


def _finish_build(job):
    """Wait for one nvcc; return its error message (with the nvcc log), or
    None once the library is in place."""
    name, proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        return f"nvcc failed for {SOURCES[name]}:\n{log}"
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    return None


def build_all(names: Iterable[str] = tuple(SOURCES)) -> None:
    """Compile every missing library, all `nvcc`s running at once; every
    one is waited for before a failure is raised."""
    with _lock:
        jobs = [j for j in (_start_build(n) for n in names) if j]
        errors = [e for e in (_finish_build(j) for j in jobs) if e]
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name` (built on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = load(_lib_path(name), name)
    return _libs[name]


def load(path: str, name: str) -> ctypes.CDLL:
    """The library at `path`, built from SOURCES[name], with its launchers'
    C signatures set (kernel_variants.py loads its own builds so)."""
    lib = ctypes.CDLL(path)
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
    lib.kernel_error_string.argtypes = [_I]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
