"""The host's native hot loops through ctypes (counterpart of
sparch_tpu/data/native.py): the event binning of the spiking datasets
(``native/binning.cpp``) and one Freeverb channel of the audio
augmentation's reverb (``native/freeverb.cpp``), both shared with the JAX
package.

Each library is built with the system ``g++`` at first use into
``build/native/`` (written under a temporary name and moved into place, so
that concurrent processes never load a half-written file) and rebuilt when
its source is newer; the JAX package's builds in ``native/`` are never
loaded. Without a toolchain ``bin_events`` runs its NumPy version, which
gives the same rasters, and ``freeverb_channel`` returns None, on which
``data.augment`` runs its SciPy formulation; the module logs which branch
each took (``native_available`` and ``freeverb_available`` say it too).
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

__all__ = [
    "bin_events",
    "native_available",
    "freeverb_channel",
    "freeverb_available",
]

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "binning.cpp")
_LIB = os.path.join(_REPO_ROOT, "build", "native", "libsparch_binning.so")
_FV_SRC = os.path.join(_REPO_ROOT, "native", "freeverb.cpp")
_FV_LIB = os.path.join(_REPO_ROOT, "build", "native", "libsparch_freeverb.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_fv_lib: Optional[ctypes.CDLL] = None
_fv_tried = False


def _build(src: str, lib: str) -> None:
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                       check=True, capture_output=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _open(src: str, lib: str) -> ctypes.CDLL:
    """The library built from ``src``, (re)built first where it is missing
    or older than its source."""
    if not os.path.exists(lib) or os.path.getmtime(src) > os.path.getmtime(lib):
        _build(src, lib)
    return ctypes.CDLL(lib)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = _open(_SRC, _LIB)
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


def _load_freeverb() -> Optional[ctypes.CDLL]:
    global _fv_lib, _fv_tried
    with _lock:
        if _fv_tried:
            return _fv_lib
        _fv_tried = True
        try:
            lib = _open(_FV_SRC, _FV_LIB)
            lib.freeverb_channel.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.c_double,
                ctypes.c_double,
                ctypes.POINTER(ctypes.c_double),
            ]
            lib.freeverb_channel.restype = None
            _fv_lib = lib
            logger.info(f"freeverb: native library {_FV_LIB}")
        except Exception as e:  # toolchain-dependent
            logger.info(f"freeverb: SciPy (native unavailable: {e})")
            _fv_lib = None
        return _fv_lib


def freeverb_available() -> bool:
    return _load_freeverb() is not None


def freeverb_channel(
    x: np.ndarray,
    comb_lens: np.ndarray,
    ap_lens: np.ndarray,
    feedback: float,
    damp: float,
) -> Optional[np.ndarray]:
    """One Freeverb channel (float64) through the native library: the combs
    of ``comb_lens`` in parallel, then the allpasses of ``ap_lens`` in
    series, in the order given. None when the library is unavailable (the
    caller then runs the SciPy formulation)."""
    lib = _load_freeverb()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float64)
    comb_lens = np.ascontiguousarray(comb_lens, np.int64)
    ap_lens = np.ascontiguousarray(ap_lens, np.int64)
    out = np.empty_like(x)
    lib.freeverb_channel(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(len(x)),
        comb_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(comb_lens)),
        ap_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(ap_lens)),
        ctypes.c_double(feedback),
        ctypes.c_double(damp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


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
