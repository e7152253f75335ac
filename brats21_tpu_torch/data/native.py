"""ctypes binding of the port's native case loader (``csrc/nifti_native.cc``).

The port's counterpart of ``brats21_tpu/data/native.py``: one C++ call
decodes a case's four modality files (zlib inflate, a thread a modality),
crops them to the any-channel foreground and z-scores the nonzero voxels of
each channel, handing back a float32 [X, Y, Z, C] block. The library is
built at first use with ``$CXX`` (``g++`` when unset) and the flags of the
JAX package's ``native/Makefile`` into ``brats21_tpu_torch/_build/``.

When the library cannot be built or loaded, or a load fails, the dataset
decodes on the numpy path: one warning says so, and :func:`take_counts`
tells the cases served by each path.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional, Sequence

import numpy as np

from .. import get_logger
from ..ops.kernels import build_library

logger = get_logger("native")

SOURCE = "nifti_native.cc"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
LIBS = ("-lz",)

#: cases decoded by the library, and cases the dataset sent to the numpy
#: path because the library was missing or failed, since the last take
loads = 0
fallbacks = 0
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[Exception] = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.bt_load_case.restype = ctypes.c_void_p
    lib.bt_load_case.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.bt_case_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.bt_case_data.argtypes = [ctypes.c_void_p]
    for name, ctype, n in (("bt_case_shape", ctypes.c_int64, 4),
                           ("bt_case_bbox", ctypes.c_int64, 6),
                           ("bt_case_orig_shape", ctypes.c_int64, 3),
                           ("bt_case_affine", ctypes.c_double, 16)):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctype * n)]
    lib.bt_free_case.restype = None
    lib.bt_free_case.argtypes = [ctypes.c_void_p]
    lib.bt_last_error.restype = ctypes.c_char_p
    lib.bt_last_error.argtypes = []
    return lib


def library() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None (after one
    warning) when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                path = build_library(SOURCE, os.environ.get("CXX") or "g++",
                                     CXX_FLAGS, LIBS)
                _lib = _bind(ctypes.CDLL(str(path)))
            except (OSError, RuntimeError) as e:
                _error = e
                logger.warning("native case loader unavailable, cases decode on the "
                               "numpy path: %s", e)
        return _lib


def count(native: bool) -> None:
    """One case served by the library (``native``) or by the fallback."""
    global loads, fallbacks
    with _lock:
        if native:
            loads += 1
        else:
            fallbacks += 1


def take_counts() -> Dict[str, int]:
    """``{"loads", "fallbacks"}`` since the last take, zeroed."""
    global loads, fallbacks
    with _lock:
        out = dict(loads=loads, fallbacks=fallbacks)
        loads = fallbacks = 0
    return out


def load_case_native(paths: Sequence[str], crop: bool = True, normalize: bool = True,
                     remove_outliers: bool = False) -> Optional[Dict[str, np.ndarray]]:
    """``{img [X, Y, Z, C] fp32, foreground_start_coord,
    foreground_end_coord, original_shape, affine}`` of the modality files
    ``paths``, or None when the library is unavailable or the load fails
    (logged with the library's error)."""
    lib = library()
    if lib is None:
        return None
    names = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    handle = lib.bt_load_case(names, len(paths), int(crop), int(normalize),
                              int(remove_outliers))
    if not handle:
        # bt_last_error is thread-local: read on the thread that loaded
        logger.warning("native load of %s failed: %s", paths[0],
                       lib.bt_last_error().decode(errors="replace"))
        return None
    try:
        shape = (ctypes.c_int64 * 4)()
        lib.bt_case_shape(handle, shape)
        n = int(np.prod(shape[:]))
        img = np.ctypeslib.as_array(lib.bt_case_data(handle), shape=(n,))
        img = img.reshape(tuple(shape[:])).copy()
        bbox = (ctypes.c_int64 * 6)()
        lib.bt_case_bbox(handle, bbox)
        orig = (ctypes.c_int64 * 3)()
        lib.bt_case_orig_shape(handle, orig)
        affine = (ctypes.c_double * 16)()
        lib.bt_case_affine(handle, affine)
    finally:
        lib.bt_free_case(handle)
    return {
        "img": img,
        "foreground_start_coord": np.asarray(bbox[:3], np.int64),
        "foreground_end_coord": np.asarray(bbox[3:], np.int64),
        "original_shape": np.asarray(orig[:], np.int64),
        "affine": np.asarray(affine[:], np.float64).reshape(4, 4),
    }
