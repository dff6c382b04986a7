"""Phase timers and profiler traces — counterpart of the JAX package's
``utils/timers.py``.

Nested named phases with a report.  PyTorch returns before the card has
finished the work it was given, so a phase synchronises the CUDA devices
(when there are any) at its end: the time of a phase is the time of its
work, not of its enqueue.  :func:`trace_to` writes a ``torch.profiler``
trace of a block, JAX's ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from typing import Dict, Iterator, Optional

import torch

__all__ = ["PhaseTimer", "trace_to"]


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


@contextlib.contextmanager
def trace_to(logdir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` trace of the block, written as a Chrome trace
    (``trace.<pid>.<ns>.json``) into ``logdir``: host activity, and the
    card's when CUDA is available.  Does nothing when ``logdir`` is None
    (JAX's ``trace_to``)."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        _synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace.{os.getpid()}.{time.time_ns()}.json"))
