"""Where the port's kernel builds are kept and reused.

Counterpart of the JAX package's ``utils/compilecache.py``, which points
JAX's persistent compilation cache at a directory so that a second run of
a driver skips its compiles.  The port's compiled artefacts are the shared
libraries ``nvcc`` builds from ``csrc/`` (``ops/_kernels.py``), each named
by a hash of its source, the shared headers and the build flags, so a
directory of them is a cache by construction: a build that is there is
loaded, any other is compiled into it.

The directory is, in this order:

- the ``path`` given to :func:`enable_persistent_cache`;
- the ``DDPS_COMPILE_CACHE`` environment variable;
- the default: the checkout's gitignored ``build/kernels/`` when the
  package runs from a checkout, a per-user cache directory
  (``$XDG_CACHE_HOME`` or ``~/.cache``, then ``ddps_torch_kernels``) when
  it is installed, never a directory inside ``site-packages``.

``DDPS_NO_COMPILE_CACHE=1`` turns the cache off (for instance to time the
builds themselves): every process then builds into a fresh temporary
directory of its own, removed when it exits.
"""

from __future__ import annotations

import atexit
import os
import pathlib
import shutil
import tempfile
from typing import Optional

__all__ = ["default_cache_dir", "enable_persistent_cache", "kernel_build_dir"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
_UNSET = object()
# What enable_persistent_cache chose: a directory, None (no cache), or
# _UNSET (never called: the environment decides at each build).
_chosen = _UNSET
_temp: Optional[pathlib.Path] = None


def default_cache_dir() -> pathlib.Path:
    """The default directory: ``build/kernels`` beside the package in a
    checkout, the per-user cache directory when the package lies in
    ``site-packages`` or ``dist-packages``."""
    if {"site-packages", "dist-packages"} & set(_PKG.parts):
        base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
            os.path.expanduser("~"), ".cache")
        return pathlib.Path(base) / "ddps_torch_kernels"
    return _PKG.parent / "build" / "kernels"


def _resolve(path) -> Optional[pathlib.Path]:
    if os.environ.get("DDPS_NO_COMPILE_CACHE", "").strip() == "1":
        return None
    return pathlib.Path(path or os.environ.get("DDPS_COMPILE_CACHE")
                        or default_cache_dir())


def enable_persistent_cache(path: Optional[str] = None) -> Optional[str]:
    """Keep the kernel builds in ``path`` (else ``DDPS_COMPILE_CACHE``,
    else the default) from now on, creating it; returns the directory, or
    None when ``DDPS_NO_COMPILE_CACHE=1`` or the directory cannot be made
    (builds then go to a per-process temporary directory).  A kernel
    already loaded keeps its library."""
    global _chosen
    cache_dir = _resolve(path)
    if cache_dir is not None:
        try:
            cache_dir.mkdir(parents=True, exist_ok=True)
        except OSError:
            cache_dir = None
    _chosen = cache_dir
    return None if cache_dir is None else str(cache_dir)


def kernel_build_dir() -> pathlib.Path:
    """The directory the next kernel build goes to."""
    global _temp
    chosen = _resolve(None) if _chosen is _UNSET else _chosen
    if chosen is not None:
        return chosen
    if _temp is None:
        _temp = pathlib.Path(tempfile.mkdtemp(prefix="ddps_kernels_"))
        atexit.register(shutil.rmtree, _temp, True)
    return _temp
