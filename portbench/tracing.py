"""Spans around the calls into the program, and the reduction of a
``torch.profiler`` trace of the measured window to the numbers the
per-layer readers and the ``breakdown`` take.

Every span is timed by the host's clock; in a traced run it is also a
``record_function`` range named ``pb.<name>``, so that the trace places it
on the device's clock.  The trace is reduced in the process, never written
to disk.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["Spans", "Trace", "profiler", "reduce_trace", "reduce_device",
           "mark_fine"]

PREFIX = "pb."
# Device-side copies of host ranges, left out of the device's work: the
# spans' own, and the ``nccl:<op>`` ranges that c10d puts around each
# collective's kernel (a second entry for the same work).
RANGES = (PREFIX, "nccl:")
COPIES = ("Memcpy", "Memset")
LAUNCHES = ("cudaLaunch", "cuLaunch")  # the runtime's and driver's calls


class _Span:
    __slots__ = ("name", "ms")

    def __init__(self, name: str):
        self.name = name
        self.ms: Optional[float] = None


class Spans:
    """Host-clock spans, nested; ``pb.<name>`` ranges when ``tracing``."""

    def __init__(self, tracing: bool):
        self.tracing = tracing
        self.totals: Dict[str, float] = {}  # name -> seconds, summed

    @contextlib.contextmanager
    def span(self, name: str):
        rec = _Span(name)
        ctx = contextlib.nullcontext()
        if self.tracing:
            from torch.profiler import record_function

            ctx = record_function(PREFIX + name)
        t0 = time.perf_counter()
        with ctx:
            try:
                yield rec
            finally:
                dt = time.perf_counter() - t0
                rec.ms = dt * 1e3
                self.totals[name] = self.totals.get(name, 0.0) + dt


def profiler(activities=("cpu", "cuda")):
    from torch.profiler import ProfilerActivity, profile

    acts = [getattr(ProfilerActivity, a.upper()) for a in activities]
    return profile(activities=acts)


def mark_fine(spans: Spans, kind: str, operator) -> None:
    """Make every product of ``operator`` a span ``fine.<kind>.<bytes>``
    (bytes of one vector element), so that a trace tells the kernels it
    launches from those of other operators: the wrapper is the instance's
    own ``matvec``, which the solver, the V-cycle's level 0 and the
    transfers all call."""
    inner = operator.matvec

    def matvec(x):
        with spans.span(f"fine.{kind}.{x.element_size()}"):
            return inner(x)

    operator.matvec = matvec


@dataclasses.dataclass
class KernelEvent:
    name: str
    start_ns: int
    end_ns: int
    launch_ns: Optional[int]  # the host's launch call, where the trace has it

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass
class Trace:
    window_ns: Tuple[int, int]
    kernels: List[KernelEvent]
    busy_ns: int
    device_ops: Dict[str, float]  # name -> seconds
    idle_by_span: Dict[str, float]  # innermost host span -> idle seconds
    spans: List[Tuple[str, int, int]]  # (name, start, end) of pb.<name>

    def launched_in(self, prefix: str, kernel: str):
        """``(event, span name)`` of each kernel whose name holds ``kernel``
        and whose launch call lies inside a span whose name starts with
        ``prefix``."""
        iv = sorted((s, e, n) for n, s, e in self.spans
                    if n.startswith(prefix))
        starts = [s for s, _e, _n in iv]
        for k in self.kernels:
            if kernel not in k.name or k.launch_ns is None:
                continue
            i = bisect.bisect_right(starts, k.launch_ns) - 1
            if i >= 0 and k.launch_ns <= iv[i][1]:
                yield k, iv[i][2]

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _events(prof):
    return prof.profiler.kineto_results.events()


def reduce_trace(prof, window: str = "window") -> Optional[Trace]:
    """The window's device work and idle time; None when the trace holds no
    ``pb.<window>`` range."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, device, kernels, launches = [], [], [], {}
    # Device events are kernels, copies and fills, and the device-side
    # copies of host ranges (:data:`RANGES`, left out); host events named
    # pb.<span> are the spans; the launch calls share their kernels'
    # correlation ids (other host events number theirs apart).
    for ev in _events(prof):
        if ev.device_type() == cuda:
            name = ev.name()
            if name.startswith(RANGES):
                continue
            s = ev.start_ns()
            e = s + ev.duration_ns()
            device.append((name, s, e))
            if not name.startswith(COPIES):
                kernels.append((name, s, e, ev.correlation_id()))
        elif ev.is_user_annotation():
            name = ev.name()
            if name.startswith(PREFIX):
                s = ev.start_ns()
                spans.append((name[len(PREFIX):], s, s + ev.duration_ns()))
        elif ev.correlation_id() and ev.name().startswith(LAUNCHES):
            launches[ev.correlation_id()] = ev.start_ns()
    kernels = [KernelEvent(n, s, e, launches.get(c) if c else None)
               for n, s, e, c in kernels]
    win = [(s, e) for n, s, e in spans if n == window]
    if not win:
        return None
    w0, w1 = win[0]
    device = [(n, max(s, w0), min(e, w1)) for n, s, e in device
              if e > w0 and s < w1]
    kernels = [k for k in kernels if k.end_ns > w0 and k.start_ns < w1]
    merged = _merge([(s, e) for _n, s, e in device])
    busy = sum(e - s for s, e in merged)
    ops: Dict[str, float] = {}
    for n, s, e in device:
        ops[n] = ops.get(n, 0.0) + (e - s) / 1e9
    return Trace((w0, w1), kernels, busy, ops,
                 _idle_by_span(merged, spans, window, w0, w1), spans)


def reduce_device(prof) -> Optional[Trace]:
    """The device's work in a trace of device activity alone, taken around
    the window and nothing else: every kernel, copy and fill in it is the
    window's; its span is the first start to the last end.  None when the
    trace holds no device work."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device = []
    for ev in _events(prof):
        if ev.device_type() == cuda and not ev.name().startswith(RANGES):
            s = ev.start_ns()
            device.append((ev.name(), s, s + ev.duration_ns()))
    if not device:
        return None
    merged = _merge([(s, e) for _n, s, e in device])
    ops: Dict[str, float] = {}
    for n, s, e in device:
        ops[n] = ops.get(n, 0.0) + (e - s) / 1e9
    return Trace((merged[0][0], merged[-1][1]), [],
                 sum(e - s for s, e in merged), ops, {}, [])


def _idle_by_span(merged, spans, window, w0, w1) -> Dict[str, float]:
    """Idle gaps of the window, each put down to the innermost host span
    open at its middle (spans nest: the last one opened), in one sweep."""
    marks = []
    for i, (n, s, e) in enumerate(spans):
        if n != window:
            marks += [(s, 1, i), (e, 0, i)]
    marks.sort()
    edges = [w0] + [v for iv in merged for v in iv] + [w1]
    gaps = [(g0, g1) for g0, g1 in zip(edges[::2], edges[1::2]) if g1 > g0]
    idle: Dict[str, float] = {}
    open_, k = [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while k < len(marks) and marks[k][0] <= mid:
            _t, kind, i = marks[k]
            if kind:
                open_.append(i)
            elif i in open_:
                open_.remove(i)
            k += 1
        name = spans[open_[-1]][0] if open_ else "none"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e9
    return idle


def top(d: Dict[str, float], k: int = 10):
    return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]
