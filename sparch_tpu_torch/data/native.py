"""Event binning on the host: the shared C++ kernel ``native/binning.cpp``
through ctypes, or its NumPy version (counterpart of the binning half of
sparch_tpu/data/native.py).

The library is built with the system ``g++`` at first use into
``build/native/`` (written under a temporary name and moved into place, so
that concurrent processes never load a half-written file) and rebuilt when
the source is newer. Without a toolchain ``bin_events`` runs the NumPy
version, which gives the same rasters; the module logs which of the two it
took (``native_available`` says it too).
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["bin_events", "native_available"]

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "binning.cpp")
_LIB = os.path.join(_REPO_ROOT, "build", "native", "libsparch_binning.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> None:
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_LIB) or (
                os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
            ):
                _build()
            lib = ctypes.CDLL(_LIB)
            lib.bin_events.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.bin_events.restype = None
            _lib = lib
            logger.info(f"event binning: native library {_LIB}")
        except Exception as e:  # toolchain-dependent
            logger.info(f"event binning: NumPy (native unavailable: {e})")
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


def _bin_events_np(
    times: np.ndarray, units: np.ndarray, edges: np.ndarray,
    nb_steps: int, nb_units: int,
) -> np.ndarray:
    # Events at/after the last edge digitize to nb_steps and are dropped,
    # as are units outside [0, nb_units)
    idx = np.digitize(times, edges)
    keep = (idx < nb_steps) & (units >= 0) & (units < nb_units)
    out = np.zeros((nb_steps, nb_units), np.float32)
    np.add.at(out, (idx[keep], units[keep]), 1.0)
    return out


def bin_events(
    times: np.ndarray,
    units: np.ndarray,
    edges: np.ndarray,
    nb_steps: int,
    nb_units: int,
) -> np.ndarray:
    """Dense (nb_steps, nb_units) spike raster from event times/units."""
    lib = _load()
    times = np.ascontiguousarray(times, np.float64)
    units = np.ascontiguousarray(units, np.int64)
    if lib is None:
        return _bin_events_np(times, units, edges, nb_steps, nb_units)
    edges = np.ascontiguousarray(edges, np.float64)
    out = np.zeros((nb_steps, nb_units), np.float32)
    lib.bin_events(
        times.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        units.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(times)),
        edges.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(len(edges)),
        ctypes.c_int64(nb_steps),
        ctypes.c_int64(nb_units),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
