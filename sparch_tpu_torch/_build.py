"""Build the CUDA kernels of ``csrc/`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so``
at the repository root; the hash covers the source and the flags, so an
edited source builds anew. :func:`build` starts one ``nvcc`` per missing
library, all at once, and waits for them; :class:`Kernel` builds its own
library at its first launch. Nothing is compiled or loaded at import time.

:func:`set_build_dir` moves the builds elsewhere (``--compile_cache``,
``utils/cache.py``). :func:`load` opens each library once a process, by
its file name (which carries the digest): a library loaded before the
move stays the one in use, and no kernel is ever loaded twice.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "BUILD_DIR", "build", "library_path", "load",
           "set_build_dir", "Kernel"]

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
BUILD_DIR = DEFAULT_BUILD_DIR
SOURCES = ("fused_cell_fwd", "fused_cell_bwd", "readout_fwd", "readout_bwd",
           "fused_ann_fwd", "fused_ann_bwd", "tp_collectives", "tp_cell_fwd",
           "tp_cell_bwd", "tp_ann_fwd", "tp_ann_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built from source at first use"
        )
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built."""
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def set_build_dir(path=None) -> Path:
    """Build and load the libraries in ``path`` from now on (None:
    ``build/kernels`` at the repository root). Returns the directory."""
    global BUILD_DIR
    BUILD_DIR = DEFAULT_BUILD_DIR if path is None else \
        Path(path).expanduser().resolve()
    return BUILD_DIR


_LOADED: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built where missing; opened once
    a process for each digest of its sources."""
    path = library_path(name)
    lib = _LOADED.get(path.name)
    if lib is None:
        if not path.exists():
            build([name])
        lib = _LOADED[path.name] = ctypes.CDLL(str(path))
    return lib


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together. Returns the compiler's output (ptxas
    register and shared-memory report) by name; raises if any build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    if failed:
        details = "\n".join(f"--- {n}\n{logs[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{details}")
    return logs


class Kernel:
    """One C entry point of a ``csrc/`` library.

    Calling it launches the kernel on the given stream and raises if the
    launch was refused (the C function returns ``cudaGetLastError()``).
    ``launches`` counts the launches that went through, so a run can show
    that its path reached the kernel; ``name`` (the source's, unless one
    source has several entry points) is the key it is reported under.
    """

    def __init__(self, source: str, symbol: str, argtypes,
                 name: Optional[str] = None):
        self.source = source
        self.symbol = symbol
        self.name = name or source
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None

    def _load(self):
        fn = getattr(load(self.source), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, *args) -> None:
        if self._fn is None:
            self._fn = self._load()
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} failed: cudaError_t {err}")
        self.launches += 1
