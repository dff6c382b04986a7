"""Phase timers — counterpart of the JAX package's ``utils/timers.py``.

Nested named phases with a report.  PyTorch returns before the card has
finished the work it was given, so a phase synchronises the CUDA devices
(when there are any) at its end: the time of a phase is the time of its
work, not of its enqueue.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Dict, Iterator

import torch

__all__ = ["PhaseTimer"]


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Accumulating named phase timer.

    >>> timer = PhaseTimer()
    >>> with timer.phase("assembly"):
    ...     ...
    >>> print(timer.report())
    """

    def __init__(self):
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        if not self.totals:
            return "(no phases timed)"
        width = max(len(k) for k in self.totals)
        lines = [
            f"{k:<{width}}  {v:9.3f}s  x{self.counts[k]}"
            for k, v in self.totals.items()
        ]
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)
