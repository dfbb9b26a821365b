"""ctypes bindings for the native JPEG decode pipeline.

The C++ library (orbit_tpu_torch/data/_native/orbit_decoder.cpp) fuses
read -> jpeg decode (DCT-prescaled) -> bilinear resize -> float32 normalize
in a C++ thread pool, replacing the reference's per-frame PIL transform in
DataLoader workers (reference: data/datasets.py:376-431 — its pipeline hot
loop). It is built on demand with g++ (scripts/build_native.sh) and loaded
lazily; callers fall back to the PIL path when unavailable.

Note: resize uses bilinear (the standard production choice) while the PIL
fallback uses LANCZOS, matching the reference's offline resize_videos.py.
The benchmark ZIPs ship pre-resized at 224, so the runtime resample filter is
a no-op for the standard protocol.

Copy of ``orbit_tpu/data/native_decoder.py`` for the PyTorch port, which imports
nothing of the JAX package; keep the two in step.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "liborbit_decoder.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "orbit_decoder.cpp")

_lib = None
_lib_error: Optional[str] = None


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-pthread",
             "-o", _LIB_PATH, _SRC_PATH, "-ljpeg"],
            check=True, capture_output=True, timeout=120)
        return True
    except Exception as e:  # no g++ / no libjpeg: fall back to PIL
        global _lib_error
        _lib_error = f"native build failed: {e}"
        return False


def load_library():
    """Load (building if needed) the native decoder; None if unavailable.
    A stale .so (predating orbit_decode_batch_u8) is rebuilt in place."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    for _attempt in (0, 1):
        err = _try_load()
        if _lib is not None or _attempt or err is None:
            break
        if not _build():            # rebuild a stale library once
            break
    if _lib is None and _lib_error is None:
        _lib_error = err or "unknown load failure"
    return _lib


def _try_load():
    global _lib, _lib_error
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.orbit_decode_batch.restype = ctypes.c_int
        lib.orbit_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        if not hasattr(lib, "orbit_decode_batch_u8"):
            raise OSError("stale liborbit_decoder.so: missing "
                          "orbit_decode_batch_u8 (rebuild via "
                          "scripts/build_native.sh)")
        lib.orbit_decode_batch_u8.restype = ctypes.c_int
        lib.orbit_decode_batch_u8.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        _lib = lib
        return None
    except OSError as e:
        return str(e)


def native_available() -> bool:
    return load_library() is not None


def decode_batch(paths: Sequence[str], frame_size: int,
                 mean: np.ndarray, std: np.ndarray,
                 n_threads: int = 4) -> np.ndarray:
    """Decode ``paths`` -> (N, frame_size, frame_size, 3) float32 normalized.

    Raises RuntimeError if the native library is unavailable or any frame
    fails to decode (callers may catch and fall back to PIL).
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_lib_error}")
    n = len(paths)
    out = np.empty((n, frame_size, frame_size, 3), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    failures = lib.orbit_decode_batch(
        c_paths, n, frame_size,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads)
    if failures:
        raise RuntimeError(f"native decoder failed on {failures}/{n} frames")
    return out


def decode_batch_raw(paths: Sequence[str], frame_size: int,
                     n_threads: int = 4) -> np.ndarray:
    """Decode ``paths`` -> (N, frame_size, frame_size, 3) uint8 raw pixels
    (the uint8 wire format — normalization happens on device,
    models/recognisers.py ``_maybe_normalize``).

    Raises RuntimeError if the native library is unavailable or any frame
    fails to decode (callers may catch and fall back to PIL).
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_lib_error}")
    n = len(paths)
    out = np.empty((n, frame_size, frame_size, 3), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    failures = lib.orbit_decode_batch_u8(
        c_paths, n, frame_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_threads)
    if failures:
        raise RuntimeError(f"native decoder failed on {failures}/{n} frames")
    return out
