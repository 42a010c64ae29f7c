"""Where the CUDA kernels are built (counterpart of
sparch_tpu/utils/cache.py).

The JAX package keeps XLA's compiled programs in a persistent cache; what
the port compiles is its kernel libraries (``_build.py``: one ``nvcc`` per
``csrc/`` source, each library named by the digest of its sources and
flags). ``run_exp_torch.py --compile_cache DIR`` builds and loads them in
``DIR``, so that runs from other checkouts or processes share one build;
unset (or a false string) it is ``build/kernels`` in the checkout. The
libraries are always built from the checkout's sources: a stale one has
another digest and is never loaded. A library already loaded in the
process stays loaded whatever the directory (``_build.load``).
"""
from __future__ import annotations

import os
import tempfile
from pathlib import Path

from sparch_tpu_torch import _build

__all__ = ["use_compile_cache", "resolve_cache_arg", "default_cache_dir"]

_TRUEY = ("true", "1", "yes", "on")
_FALSY = ("false", "0", "no", "off", "none", "")


def resolve_cache_arg(value):
    """Map a ``--compile_cache`` CLI value to a directory, None (the
    default directory) or False (off): every other flag of the reference's
    schema is a true/false
    string, so users type ``--compile_cache true``, which taken as a path
    would make a directory named ``true/``. Boolean strings mean "default
    directory" (returns None) or "disabled" (returns False); anything else
    is a path."""
    if value is None or value is False:
        return False
    if isinstance(value, str):
        if value.lower() in _FALSY:
            return False
        if value.lower() in _TRUEY:
            return None
    if value is True:
        return None
    return value


def default_cache_dir() -> str:
    """A stable per-user directory under the temporary directory."""
    return os.path.join(tempfile.gettempdir(),
                        f"sparch_tpu_torch_kernels_{os.getuid()}")


def use_compile_cache(value) -> Path:
    """Build and load the kernels where the ``--compile_cache`` value
    ``value`` says (``resolve_cache_arg``): a path, the per-user default
    directory, or, false or None, ``build/kernels`` in the checkout.
    Returns the directory."""
    cache_dir = resolve_cache_arg(value)
    if cache_dir is False:
        return _build.set_build_dir(None)
    return _build.set_build_dir(cache_dir or default_cache_dir())
