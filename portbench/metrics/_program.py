"""The program's own spans and counters, from the port's recorder
(``utils/timers.py``: ``RECORDER``), laid on the traced window: spans are
stamped with ``time.time_ns()``, the clock ``torch.profiler`` stamps its
host events with, so a span whose start lies in ``run.trace.window_ns``
ran inside the window.  Per-answer values divide by the window's answers.

Every helper returns None, never 0, where there is nothing to read: a
program without the recorder, a run without a trace, or a ring that
dropped spans that started inside the window.
"""

from __future__ import annotations

from typing import List, Optional


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from domain_decomposed_pde_solver_tpu_torch.utils import timers
    except ImportError:
        return None
    return getattr(timers, "RECORDER", None)


def held_spans(run) -> Optional[List]:
    """Every span the recorder holds, in a traced run."""
    rec = recorder()
    if rec is None or run.trace is None or not run.records:
        return None
    return rec.spans()


def window_spans(run) -> Optional[List]:
    """The spans that started inside the traced window."""
    spans = held_spans(run)
    if spans is None:
        return None
    w0, w1 = run.trace.window_ns
    rec = recorder()
    if rec.dropped and rec.complete_since_ns >= w0:
        return None
    return [s for s in spans if w0 <= s.start_ns <= w1]


def per_answer(run, total: float) -> float:
    return total / len(run.records)


def outermost(spans: List, name: str) -> List:
    """The spans ``name`` not inside another of that name (a put that
    calls another put counts once)."""
    named = [s for s in spans if s.name == name]
    ids = {s.id for s in named}
    return [s for s in named if s.parent not in ids]


def span_ms(run, name: str) -> Optional[float]:
    """Milliseconds per answer in the spans ``name``; None where the window
    holds none."""
    spans = window_spans(run)
    if spans is None:
        return None
    ns = [s.end_ns - s.start_ns for s in outermost(spans, name)]
    return per_answer(run, sum(ns) / 1e6) if ns else None


def counter(run, *names: str) -> Optional[float]:
    """The counters ``names``, summed over the window's spans, per
    answer."""
    spans = window_spans(run)
    if spans is None:
        return None
    return per_answer(run, sum((s.counts or {}).get(n, 0)
                               for s in spans for n in names))
