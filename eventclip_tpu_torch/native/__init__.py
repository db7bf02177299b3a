"""ctypes bindings for the native host data path (event_ops.cpp).

Port of eventclip_tpu/native/__init__.py. The per-item stream transform
(center -> tflip -> shift(+drop) -> hflip), the window packing and the
N-ImageNet record decode run as one fused C++ pass each, with the GIL
released (ctypes `CDLL` calls drop it), so loader threads and serving
requests overlap. `event_ops.cpp` is the JAX package's source, kept here
as a byte-identical copy (a test pins it). The library is built with `g++
-O3 -std=c++17 -shared -fPIC` at first use into the package's git-ignored
`_build/`, and rebuilt when the source is newer than it. Every caller falls
back to the numpy path in data/host_ops.py when the library is
unavailable (no compiler); both are bit-identical
(tests/test_torch_native.py).

Each wrapper adds one to `CALLS[name]` where it calls into the library and
nowhere else, so a run can show that its host path went through it
(`reset_calls` before, read after).

Environment:
    EVENTCLIP_NATIVE=0   never load/build/use the native library
    EVENTCLIP_NATIVE=1   (or unset) use it when loadable; auto-build once
"""

from __future__ import annotations

import collections
import ctypes
import os
import subprocess
import tempfile
import threading
import warnings
from typing import Dict, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "event_ops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
LIB = os.path.join(BUILD_DIR, "libevent_ops.so")

CALLS: Dict[str, int] = collections.Counter()
_calls_lock = threading.Lock()

_lib = None
_tried = False
_error: Optional[str] = None


def reset_calls() -> None:
    with _calls_lock:
        CALLS.clear()


def _count(name: str) -> None:
    with _calls_lock:
        CALLS[name] += 1


def build(out_path: str = LIB) -> None:
    """Compile event_ops.cpp -> out_path. Atomic (tmp + rename), so racing
    processes each produce a valid library and the last rename wins. The
    directory of out_path must exist. Raises RuntimeError holding the
    command and the compiler's error text when the build fails."""
    compiler = os.environ.get("CXX", "g++")
    tmp = None
    try:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out_path))
        os.close(fd)
        cmd = [compiler, "-O3", "-std=c++17", "-shared", "-fPIC", SRC,
               "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build failed ({' '.join(cmd)}):\n{proc.stderr}")
        os.replace(tmp, out_path)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native build failed: {e}") from e
    finally:
        if tmp and os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("EVENTCLIP_NATIVE", "1") == "0":
        _error = "turned off by EVENTCLIP_NATIVE=0"
        return None
    try:
        if not os.path.exists(LIB):
            # first use on this checkout: build once; a failure falls back
            # to the numpy path, exact by definition, in silence
            os.makedirs(BUILD_DIR, exist_ok=True)
            build(LIB)
        elif os.path.getmtime(SRC) > os.path.getmtime(LIB):
            # a library from an older source; rebuild. Loading the outdated
            # one anyway could silently break the bit-parity contract, so a
            # failed rebuild is loud
            try:
                build(LIB)
            except RuntimeError as e:
                warnings.warn(
                    f"{LIB} is older than {SRC} and the rebuild failed; "
                    "using the STALE native kernels — set EVENTCLIP_NATIVE=0 "
                    "or fix the toolchain if event_ops.cpp semantics "
                    f"changed. {e}"
                )
    except (OSError, RuntimeError) as e:
        _error = str(e)
        return None
    try:
        lib = ctypes.CDLL(LIB)
    except OSError as e:
        warnings.warn(f"native event_ops present but unloadable: {e}")
        _error = str(e)
        return None
    lib.ec_transform.restype = ctypes.c_int64
    lib.ec_transform.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.ec_pack_spans.restype = None
    lib.ec_pack_spans.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.ec_pack_spans_f32.restype = None
    lib.ec_pack_spans_f32.argtypes = lib.ec_pack_spans.argtypes
    lib.ec_decode_struct.restype = None
    lib.ec_decode_struct.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p,
    ]
    _lib = lib
    return _lib


# numpy dtype kind+itemsize -> ec_read type code (event_ops.cpp)
_DTYPE_CODES = {
    ("u", 1): 0, ("b", 1): 0, ("i", 1): 1, ("u", 2): 2, ("i", 2): 3,
    ("u", 4): 4, ("i", 4): 5, ("u", 8): 6, ("i", 8): 7,
    ("f", 4): 8, ("f", 8): 9,
}


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the library is unavailable (the build's error text, an
    unloadable file, or the switch), or None."""
    _load()
    return _error


def reset_for_tests() -> None:
    """Drop the cached handle so the load/build rules run again (tests, and
    switching EVENTCLIP_NATIVE within one process)."""
    global _lib, _tried, _error
    _lib, _tried, _error = None, False, None


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def decode_struct(records: np.ndarray) -> Optional[np.ndarray]:
    """Decode an N-ImageNet structured record array (fields x, y, t, p) to
    [n, 4] float32, bit-identical to datasets.load_event_npz's numpy chain.
    Returns None when the library is unavailable or the dtype is outside
    the supported envelope (the caller falls back to numpy): non-native
    byte order, missing fields, or a float polarity field (numpy's
    float->uint8 cast of negatives is platform-defined; integers/bools are
    well-defined truncation)."""
    lib = _load()
    if lib is None or records.dtype.fields is None:
        return None
    fields = []
    for name in ("x", "y", "t", "p"):
        f = records.dtype.fields.get(name)
        if f is None:
            return None
        dt, off = f[0], f[1]
        # ec_read memcpy's into native-endian types, so only native-order
        # fields are decodable here
        if dt.shape != () or not dt.isnative:
            return None
        code = _DTYPE_CODES.get((dt.kind, dt.itemsize))
        if code is None or (name == "p" and dt.kind == "f"):
            return None
        fields.extend((off, code))
    rec = np.ascontiguousarray(records)
    out = np.empty((len(rec), 4), np.float32)
    _count("decode_struct")
    lib.ec_decode_struct(
        ctypes.c_void_p(rec.ctypes.data), len(rec), rec.dtype.itemsize,
        *fields, _ptr(out),
    )
    return out


def transform_events(
    events: np.ndarray,
    resolution: Tuple[int, int],
    *,
    center: bool = False,
    tflip: bool = False,
    shift: Optional[Tuple[int, int]] = None,
    hflip: bool = False,
) -> np.ndarray:
    """Fused center -> tflip -> shift(+drop) -> hflip over an [n, 4] float32
    stream; bit-identical to applying data/host_ops.py's center_events /
    tflip_events / shift_events / hflip_events in that order. Returns a new
    array (the input is never mutated, unlike the in-place numpy ops)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable; guard on available()")
    ev = np.ascontiguousarray(events, dtype=np.float32)
    n = len(ev)
    if center and n == 0:
        # match the numpy path: center_events reduces over the stream and
        # numpy raises on an empty reduction
        raise ValueError("cannot center an empty event stream")
    out = np.empty_like(ev)
    H, W = resolution
    dx, dy = shift if shift is not None else (0, 0)
    _count("transform")
    m = lib.ec_transform(
        _ptr(ev), n, int(H), int(W), int(center), int(tflip),
        int(shift is not None), int(dx), int(dy), int(hflip), _ptr(out),
    )
    return out[:m]


def out_buffer(out: Optional[np.ndarray], shape: Tuple[int, ...],
               dtype) -> np.ndarray:
    """`out` when it is a writable, C-contiguous array of `shape` and
    `dtype` (the caller has zeroed it), a fresh zeroed one when it is None;
    anything else raises ValueError, since the library writes through the
    pointer without bounds."""
    if out is None:
        return np.zeros(shape, dtype)
    if not (isinstance(out, np.ndarray) and out.shape == tuple(shape)
            and out.dtype == dtype and out.flags.c_contiguous
            and out.flags.writeable):
        raise ValueError(
            f"out must be a writable C-contiguous {np.dtype(dtype)} array of "
            f"shape {tuple(shape)}")
    return out


def pack_spans(
    events: np.ndarray, spans, num_views: int, window: int,
    packed: bool = True, *, out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Gather window spans into the padded view tensor
    ([num_views, window, 3] int16 or [num_views, window, 4] float32),
    zero-padded like host_ops.gather_event_windows. With `out` (a zeroed,
    writable, C-contiguous array of that shape and dtype, e.g. one
    stream's slice of a request buffer) the spans' rows are written there
    and `out` is returned; the library writes only those rows, so the
    zeros are the caller's."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable; guard on available()")
    ev = np.ascontiguousarray(events, dtype=np.float32)
    sp = np.ascontiguousarray(spans, dtype=np.int64).reshape(-1, 2)
    # the numpy path's loud failure mode: without these, bad spans would be
    # silent out-of-bounds writes/reads in C
    if len(sp) > num_views:
        raise ValueError(f"{len(sp)} spans for {num_views} view slots")
    if len(sp) and ((sp[:, 1] - sp[:, 0]).max() > window
                    or sp[:, 0].min() < 0 or sp[:, 1].max() > len(ev)):
        raise ValueError(f"span out of bounds for window={window}, "
                         f"n={len(ev)}: {sp.tolist()}")
    if packed:
        cols, dtype, fn = 3, np.int16, lib.ec_pack_spans
    else:
        cols, dtype, fn = 4, np.float32, lib.ec_pack_spans_f32
    out = out_buffer(out, (num_views, window, cols), dtype)
    _count("pack_spans")
    fn(_ptr(ev), _ptr(sp), len(sp), window, _ptr(out))
    return out
