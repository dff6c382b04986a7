"""Solver checkpoint / resume (a copy of the JAX package's
``utils/checkpoint.py``: the same file format, so a checkpoint either
package writes loads in the other).

The reference has no restart capability — its only "history" is the
per-iteration Exodus snapshots (SURVEY §5, ``ExodusIO.hpp:2042-2056``).
Here checkpointing is a first-class subsystem: the CG recurrence state
``(x, r, p, rho, iteration)`` plus metadata is saved atomically as an
``.npz`` and a solve can resume exactly (CG is a fixed recurrence, so
resuming from saved state reproduces the uninterrupted run bit-for-bit in
exact arithmetic).

Kept dependency-free (NumPy .npz, atomic rename).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["CGCheckpoint", "save_checkpoint", "load_checkpoint"]


@dataclasses.dataclass
class CGCheckpoint:
    """Complete CG recurrence state at iteration ``k``."""

    x: np.ndarray
    r: np.ndarray
    p: np.ndarray
    rz: float
    iteration: int
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


def save_checkpoint(path: str, ckpt: CGCheckpoint) -> None:
    """Atomic save (write temp + rename) so a crash never corrupts the file."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                x=np.asarray(ckpt.x),
                r=np.asarray(ckpt.r),
                p=np.asarray(ckpt.p),
                rz=np.float64(ckpt.rz),
                iteration=np.int64(ckpt.iteration),
                meta=np.frombuffer(
                    json.dumps(ckpt.meta).encode(), dtype=np.uint8
                ),
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> Optional[CGCheckpoint]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode()) if "meta" in z else {}
        return CGCheckpoint(
            x=z["x"],
            r=z["r"],
            p=z["p"],
            rz=float(z["rz"]),
            iteration=int(z["iteration"]),
            meta=meta,
        )
