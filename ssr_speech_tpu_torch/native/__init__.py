"""ctypes bindings for the native host runtime (``ssr_native.cpp``): the
port's own copy of ``ssr_speech_tpu/native``, built beside this file.

Builds ``libssr_native.so`` with g++ on first use (cached next to the
source). Every entry point has a pure-python fallback so the framework works
without a toolchain; the native path removes the CPU-bound inner loops from
the training data loader and the edit-span aligner (see the .cpp header for
the reference call sites they replace).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ssr_native.cpp")
_LIB_PATH = os.path.join(_HERE, "libssr_native.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[str]:
    if os.path.isfile(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC):
        return _LIB_PATH
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
             _SRC, "-o", _LIB_PATH],
            check=True, capture_output=True, timeout=120,
        )
        return _LIB_PATH
    except Exception as e:  # pragma: no cover - no toolchain
        logger.warning("native build failed (%s); using python fallbacks", e)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _build()
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(path)
        lib.parse_int_matrix.restype = ctypes.c_int
        lib.parse_int_matrix.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.levenshtein_ops.restype = ctypes.c_int
        lib.levenshtein_ops.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.pad_collate_i32.restype = None
        lib.pad_collate_i32.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int32,
        ]
        lib.load_wav_batch.restype = None
        lib.load_wav_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_long, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def parse_int_matrix(path: str, max_rows: int = 8, max_cols: int = 8192,
                     pad_value: int = 0) -> Optional[np.ndarray]:
    """Parse a codes txt file (K rows of ints) -> int32 [rows, cols].
    Returns None on IO failure."""
    lib = get_lib()
    if lib is None:
        try:
            with open(path) as f:
                rows = [[int(v) for v in line.split()] for line in f if line.strip()]
        except OSError:
            return None
        if not rows:
            return np.zeros((0, 0), np.int32)
        cols = len(rows[0])
        out = np.full((len(rows), cols), pad_value, np.int32)
        for i, r in enumerate(rows):
            out[i, :min(len(r), cols)] = r[:cols]
        return out
    buf = np.empty((max_rows, max_cols), np.int32)
    n_rows = ctypes.c_int(0)
    n_cols = ctypes.c_int(0)
    rc = lib.parse_int_matrix(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_rows, max_cols, pad_value,
        ctypes.byref(n_rows), ctypes.byref(n_cols),
    )
    if rc != 0:
        return None
    return buf[: n_rows.value, : n_cols.value].copy()


def levenshtein_ops(a: np.ndarray, b: np.ndarray
                    ) -> Optional[List[Tuple[int, int, str]]]:
    """Alignment ops between int sequences; None if native lib unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    max_ops = len(a) + len(b) + 1
    ops = np.empty((max_ops, 3), np.int32)
    n_ops = ctypes.c_int(0)
    rc = lib.levenshtein_ops(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(a),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(b),
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_ops,
        ctypes.byref(n_ops),
    )
    if rc < 0:
        return None
    kinds = {0: "d", 1: "i", 2: "s"}
    return [(int(s), int(e), kinds[int(k)]) for s, e, k in ops[: n_ops.value]]


def pad_collate(rows: List[np.ndarray], width: int, pad_value: int) -> np.ndarray:
    """Stack variable-length int rows into a padded [n, width] matrix."""
    lib = get_lib()
    n = len(rows)
    if lib is None:
        out = np.full((n, width), pad_value, np.int32)
        for i, r in enumerate(rows):
            l = min(len(r), width)
            out[i, :l] = r[:l]
        return out
    rows32 = [np.ascontiguousarray(r, np.int32) for r in rows]
    ptrs = (ctypes.POINTER(ctypes.c_int32) * n)(
        *[r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) for r in rows32]
    )
    lens = np.asarray([len(r) for r in rows32], np.int32)
    out = np.empty((n, width), np.int32)
    lib.pad_collate_i32(
        ptrs, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), width, pad_value,
    )
    return out


def load_wav_batch(paths: List[str], target_sr: int, seg: int,
                   fracs: np.ndarray, n_threads: int = 8
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Threaded batch WAV loader: parse + mono-mix + segment-crop ``paths``
    into float32 [n, seg] in parallel (C++ thread pool over files — the
    reference does this per item in torch DataLoader workers,
    audiocraft audio_dataset.py). ``fracs[i]`` in [0, 1) picks row i's crop
    start. Returns (out, errs); errs[i] != 0 means row i needs the python
    path (1 io/parse, 2 resample required, 3 unsupported encoding).
    None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, seg), np.float32)
    errs = np.empty((n,), np.int32)
    fracs = np.ascontiguousarray(fracs, np.float64)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.load_wav_batch(
        c_paths, n, target_sr, seg,
        fracs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        errs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads,
    )
    return out, errs
