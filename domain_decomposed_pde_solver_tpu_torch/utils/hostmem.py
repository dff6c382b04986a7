"""Host allocator tuning: big host buffers reused from the heap.

A copy of the JAX package's ``utils/hostmem.py``.  glibc serves every
allocation above ``M_MMAP_THRESHOLD`` (128 KB by default) with ``mmap``
and returns it on free, so every large NumPy temporary of the host
assembly, partitioning and AMG set-up pays its first-touch page faults
again.  :func:`enable_malloc_reuse` raises the threshold so big buffers
come from the heap arena, where freed memory is reused.  The process's
high-water mark stays allocated; set ``DDPS_NO_MALLOC_TUNING=1`` to opt
out.  The package enables it at import, as JAX's does.

The reference never hits this because Trilinos pre-allocates its CRS
storage once (``ExodusIO.hpp:418-422``); a NumPy pipeline allocates per
expression.
"""

from __future__ import annotations

import ctypes
import os

__all__ = ["enable_malloc_reuse"]

_done = False


def enable_malloc_reuse(threshold_bytes: int = 1 << 30) -> bool:
    """Keep allocations below ``threshold_bytes`` on the glibc heap so
    freed buffers are reused without new page faults.  Idempotent; returns
    True if the tuning is active."""
    global _done
    if _done:
        return True
    if os.environ.get("DDPS_NO_MALLOC_TUNING"):
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_MMAP_THRESHOLD = -3
        ok = bool(libc.mallopt(M_MMAP_THRESHOLD, int(threshold_bytes)))
    except (OSError, AttributeError):
        return False  # not glibc: nothing to tune
    _done = ok
    return ok
