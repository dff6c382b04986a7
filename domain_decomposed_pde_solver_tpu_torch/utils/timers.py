"""Spans, counters, phase timers and profiler traces — counterpart of the
JAX package's ``utils/timers.py``.

The port times its own work with one recorder, :data:`RECORDER`, always
on.  :func:`span` names an interval of the host's work; :func:`count` adds
to a counter of the innermost open span.  Spans are stamped with
``time.time_ns()``, the clock ``torch.profiler`` stamps its host events
with, so a span can be laid against the kernels and launch calls of a
profiler trace; the recorder itself writes nothing into that trace (no
``record_function`` or NVTX range), so a trace holds the same device
events with it as without it.

- A span records its name, start and end, the id of its parent span, and
  a request id: the id of the outermost span open when it started, shared
  by every span of one call into the program.
- Counters are self counts: each lands on the innermost open span only,
  so nothing is counted twice up the tree.  Counting launches no work and
  synchronises nothing (bytes come from ``numel() * element_size()``).
  The counters the port keeps: ``h2d_bytes`` and ``d2h_bytes``, each copy
  between the host and a card (:func:`to_device`, :func:`to_host`), of
  which ``pinned_bytes`` those whose host side is page-locked, and
  ``host_syncs``, each blocking read of a device value by the host
  (:func:`to_host`, :func:`host_value`), counted at the call on the CPU
  too, where nothing waits; ``collectives`` and ``comm_bytes``, each
  collective across processes and the bytes this process sends in it
  (``parallel/collectives.py``).
- Closed spans go into a bounded ring; the recorder counts those it drops
  and the instant from which it holds every span that started.  Each
  thread has its own stack of open spans.

:class:`PhaseTimer` (nested named phases with a report) opens a span per
phase and synchronises the CUDA devices at the phase's end, so that the
time of a phase is the time of its work, not of its enqueue.
:func:`trace_to` writes a ``torch.profiler`` trace of a block with the
spans recorded in it, JAX's ``jax.profiler`` trace.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional

import torch

__all__ = [
    "PhaseTimer",
    "RECORDER",
    "Recorder",
    "Span",
    "count",
    "host_value",
    "record",
    "self_ns",
    "span",
    "spanned",
    "to_device",
    "to_host",
    "trace_to",
]

# At least four times the spans of a 51 s window of the busiest benchmark
# cell (about 20k); a span takes about 200 bytes.
RING_SPANS = 1 << 17


class _Stack(list):
    """A thread's open spans, innermost last, with the number of spans the
    thread has closed."""

    __slots__ = ("thread", "closed")


class Span:
    """One interval of the host's work, a context manager: entered, it is
    the innermost open span of its thread; left, it goes into the ring."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "request",
                 "counts", "_rec", "_stack")

    def __init__(self, rec: "Recorder", name: str):
        self._rec = rec
        self.name = name
        self.id = next(rec._ids)
        self.parent: Optional[int] = None
        self.request = self.id
        self.start_ns = self.end_ns = 0
        self.counts: Optional[Dict[str, int]] = None

    def _attach(self) -> "_Stack":
        stack = self._rec._stack()
        if stack:
            top = stack[-1]
            self.parent = top.id
            self.request = top.request
        self._stack = stack
        return stack

    def __enter__(self) -> "Span":
        self._attach().append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        stack = self._stack
        if stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        stack.closed += 1
        self._rec._ring.append(self)
        return False

    @property
    def thread(self) -> int:
        """The native id of the thread that ran the span."""
        return self._stack.thread

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def ms(self) -> float:
        return self.ns / 1e6

    @property
    def seconds(self) -> float:
        return self.ns / 1e9

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, ns={self.ns}, counts={self.counts})")


class Recorder:
    """Spans and their counters, in a ring of ``capacity`` closed spans."""

    def __init__(self, capacity: int = RING_SPANS):
        self._ring: "collections.deque[Span]" = collections.deque(
            maxlen=capacity)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._stacks: List[_Stack] = []  # every thread's, under the lock
        self._ids = itertools.count(1)

    def _stack(self) -> _Stack:
        try:
            return self._local.stack
        except AttributeError:
            stack = self._local.stack = _Stack()
            stack.thread = threading.get_native_id()
            stack.closed = 0
            with self._lock:
                self._stacks.append(stack)
            return stack

    @property
    def dropped(self) -> int:
        """Spans closed and no longer held."""
        with self._lock:
            closed = sum(st.closed for st in self._stacks)
        return closed - len(self._ring)

    @property
    def complete_since_ns(self) -> int:
        """Every span that started after this instant is held: the end of
        the oldest span held, once the ring has dropped any (spans leave
        it in the order they closed, so the ones dropped started before
        it; an outer span leaves after its children, so the oldest start
        held says less); 0 before."""
        if not self.dropped:
            return 0
        return self._ring[0].end_ns

    def span(self, name: str) -> Span:
        return Span(self, name)

    def record(self, name: str, start_ns: int, end_ns: int) -> Span:
        """A span already over, from ``start_ns`` to ``end_ns``, as a child
        of the innermost open span."""
        s = Span(self, name)
        s._attach().closed += 1
        s.start_ns, s.end_ns = start_ns, end_ns
        self._ring.append(s)
        return s

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` of the innermost open span of
        this thread; outside every span, nothing."""
        stack = self._stack()
        if stack:
            top = stack[-1]
            if top.counts is None:
                top.counts = {name: n}
            else:
                top.counts[name] = top.counts.get(name, 0) + n

    def spans(self) -> List[Span]:
        """The closed spans held, in the order they closed (one copy in C
        under the interpreter lock, as every append to the ring is)."""
        return list(self._ring)


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
record = RECORDER.record


def self_ns(spans: List[Span]) -> Dict[int, int]:
    """Each span's self time by id: its duration less its children's
    (the spans of ``spans`` whose parent it is)."""
    own = {s.id: s.ns for s in spans}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.ns
    return own


def spanned(name: str):
    """Decorator: every call of the function is a span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with RECORDER.span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def to_device(t: torch.Tensor, device, non_blocking: bool = False
              ) -> torch.Tensor:
    """``t.to(device, non_blocking=...)``; a copy from the host to a card
    adds its bytes to ``h2d_bytes``, and to ``pinned_bytes`` when ``t`` is
    page-locked."""
    out = t.to(device, non_blocking=non_blocking)
    if t.device.type == "cpu" and out.device.type != "cpu":
        n = t.numel() * t.element_size()
        count("h2d_bytes", n)
        if t.is_pinned():
            count("pinned_bytes", n)
    return out


def to_host(t: torch.Tensor, out: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """``t.cpu()``, or ``out.copy_(t)`` into the host tensor ``out``: a
    blocking read, one ``host_syncs``, and the bytes to ``d2h_bytes`` when
    ``t`` is on a card (and to ``pinned_bytes`` when ``out`` is
    page-locked)."""
    count("host_syncs")
    if t.device.type != "cpu":
        n = t.numel() * t.element_size()
        count("d2h_bytes", n)
        if out is not None and out.is_pinned():
            count("pinned_bytes", n)
    return t.cpu() if out is None else out.copy_(t)


def host_value(t: torch.Tensor):
    """``t.item()``, a blocking read of a one-element tensor: one
    ``host_syncs``."""
    count("host_syncs")
    return t.item()


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Accumulating named phase timer: each phase is a span.

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
        s = span(name)
        try:
            with s:
                try:
                    yield
                finally:
                    _synchronize()
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + s.seconds
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


def _add_spans(path: str, spans: List[Span]) -> None:
    """Write ``spans`` into the Chrome trace at ``path`` as complete events
    of category ``program``, on the trace's time base (microseconds from
    its ``baseTimeNanoseconds``)."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    trace.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "program", "name": s.name, "pid": pid,
         "tid": s.thread, "ts": (s.start_ns - base) / 1e3, "dur": s.ns / 1e3,
         "args": {"id": s.id, "parent": s.parent, "request": s.request,
                  **(s.counts or {})}}
        for s in spans)
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def trace_to(logdir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` trace of the block, written as a Chrome trace
    (``trace.<pid>.<ns>.json``) into ``logdir`` with the recorder's spans
    that started in the block: host activity, and the card's when CUDA is
    available.  Does nothing when ``logdir`` is None (JAX's
    ``trace_to``)."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    t0 = time.time_ns()
    prof.start()
    try:
        yield
    finally:
        _synchronize()
        prof.stop()
        path = os.path.join(logdir,
                            f"trace.{os.getpid()}.{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        _add_spans(path, [s for s in RECORDER.spans() if s.start_ns >= t0])
