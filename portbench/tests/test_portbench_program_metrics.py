"""The readers of the program's own spans and counters
(``metrics/_program.py`` and the eight metrics on it), on a synthetic run:
a recorder holding spans before, inside and after the traced window.
Each reader takes the window alone, divides by the answers, and reads
nothing (None) without the program's recorder, without a trace, or after
the ring dropped spans that started inside the window."""

import pytest

from domain_decomposed_pde_solver_tpu_torch.utils.timers import Recorder
from portbench import harness
from portbench.metrics import _program
from portbench.tracing import KernelEvent, Trace

W0, W1 = 10_000, 20_000
NEW = ["rhs_ms", "put_ms", "get_ms", "host_copy_mb", "host_syncs_per_answer",
       "cg_dispatch_ms", "cg_idle_pct", "amg_build_s"]


def _span(rec, name, start, end, parent=None, counts=None):
    s = rec.record(name, start, end)
    if parent is not None:
        s.parent, s.request = parent.id, parent.request
    s.counts = counts
    return s


def _request(rec, t, n_iter=2):
    """One solve's spans from ``t``: 1000 ns long, an iteration 100 ns of
    which 30 are its stopping test."""
    req = _span(rec, "request", t, t + 1000)
    _span(rec, "request.rhs", t + 10, t + 60, req)
    _span(rec, "request.put", t + 60, t + 80, req,
          {"h2d_bytes": 4_000_000, "host_syncs": 1, "d2h_bytes": 1_000_000})
    cg = _span(rec, "cg", t + 100, t + 100 + 100 * (n_iter + 1), req,
               {"host_syncs": 2})
    _span(rec, "cg.sync", t + 100, t + 130, cg, {"host_syncs": 1})
    for k in range(n_iter):
        a = t + 200 + 100 * k
        it = _span(rec, "cg.iter", a, a + 100, cg)
        _span(rec, "cg.sync", a + 70, a + 100, it, {"host_syncs": 1})
    _span(rec, "request.get", t + 900, t + 950, req,
          {"d2h_bytes": 2_000_000, "host_syncs": 1})
    return cg


def _run(kernels=(), n_answers=2, trace=True):
    cell = harness.load_cell("tet833k.sweep")
    rec = harness.Record({100: 1.0, 1000: 2.0}, 5.0, None, None, 2, True)
    tr = Trace((W0, W1), list(kernels), 1, {}, {}, []) if trace else None
    return harness.RunRecord(cell, [rec] * n_answers, 1.0, {}, tr, {},
                             {"n_free": 1, "nnz": 1}, None)


@pytest.fixture
def rec(monkeypatch):
    r = Recorder()
    monkeypatch.setattr(_program, "recorder", lambda: r)
    _span(r, "setup.amg", 100, 2100)  # before the window: set-up
    _request(r, 5_000, n_iter=5)  # before the window
    _request(r, W0 + 1_000)
    _request(r, W0 + 3_000)
    _request(r, W1 + 1_000, n_iter=7)  # after it
    return r


def read(name, run):
    return harness.load_reader(name)(run)


def test_each_reader_takes_the_window_and_divides_by_the_answers(rec):
    run = _run()
    assert read("rhs_ms", run) == pytest.approx(50e-6)
    assert read("put_ms", run) == pytest.approx(20e-6)
    assert read("get_ms", run) == pytest.approx(50e-6)
    assert read("host_copy_mb", run) == pytest.approx(7.0)
    # put 1 + tests 3 + reads 2 + get 1
    assert read("host_syncs_per_answer", run) == 7
    # two iterations of 100 ns less their 30 ns tests
    assert read("cg_dispatch_ms", run) == pytest.approx(140e-6)
    assert read("amg_build_s", run) == pytest.approx(2000e-9)
    four = _run(n_answers=4)
    assert read("rhs_ms", four) == pytest.approx(25e-6)
    assert read("host_syncs_per_answer", four) == 3.5


def test_cg_idle_is_the_share_of_cg_time_without_a_kernel(rec):
    # The two window solves' cg spans: [11100, 11400] and [13100, 13400].
    kernels = [KernelEvent("k", 11100, 11200, None),
               KernelEvent("k", 11150, 11250, None),  # overlaps: once
               KernelEvent("k", 12000, 12100, None),  # outside cg
               KernelEvent("k", 13350, 13500, None)]  # half inside
    got = read("cg_idle_pct", _run(kernels))
    assert got == pytest.approx(100.0 * (1 - (150 + 50) / 600))
    assert read("cg_idle_pct", _run()) is None  # no kernel in the trace


def test_a_put_inside_a_put_counts_once(rec):
    outer = _span(rec, "request.put", W0 + 5_000, W0 + 5_100)
    _span(rec, "request.put", W0 + 5_010, W0 + 5_090, outer)
    assert read("put_ms", _run()) == pytest.approx((20 + 20 + 100) / 2 * 1e-6)


def test_nested_amg_setups_count_once(rec):
    outer = _span(rec, "setup.amg", 3000, 4000)
    _span(rec, "setup.amg", 3100, 3500, outer)
    assert read("amg_build_s", _run()) == pytest.approx(3000e-9)


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_recorder_or_the_trace(rec, monkeypatch, name):
    kernels = [KernelEvent("k", 11100, 11200, None)]
    assert read(name, _run(kernels)) is not None
    assert read(name, _run(kernels, trace=False)) is None
    monkeypatch.setattr(_program, "recorder", lambda: None)
    assert read(name, _run(kernels)) is None


def test_the_parents_program_has_no_recorder(monkeypatch):
    """A program whose ``utils.timers`` lacks ``RECORDER``."""
    from domain_decomposed_pde_solver_tpu_torch.utils import timers

    monkeypatch.delattr(timers, "RECORDER")
    assert _program.recorder() is None
    for name in NEW:
        assert read(name, _run([KernelEvent("k", 11100, 11200, None)])) \
            is None


@pytest.mark.parametrize("name", [n for n in NEW if n != "amg_build_s"])
def test_none_after_a_drop_inside_the_window(monkeypatch, name):
    r = Recorder(capacity=25)
    monkeypatch.setattr(_program, "recorder", lambda: r)
    kernels = [KernelEvent("k", 11100, 11200, None)]
    _span(r, "setup.amg", 100, 2100)
    _request(r, W0 + 1_000)
    _request(r, W0 + 3_000)
    assert r.dropped == 0 and read(name, _run(kernels)) is not None
    _request(r, W1 + 1_000)  # pushes spans of the window out of the ring
    assert r.dropped > 0 and r.complete_since_ns >= W0
    assert read(name, _run(kernels)) is None


def test_a_drop_before_the_window_leaves_it_whole(monkeypatch):
    r = Recorder(capacity=25)
    monkeypatch.setattr(_program, "recorder", lambda: r)
    _request(r, 1_000, n_iter=5)
    _request(r, W0 + 1_000)
    _request(r, W0 + 3_000)
    assert r.dropped > 0 and r.complete_since_ns < W0
    assert read("rhs_ms", _run()) == pytest.approx(50e-6)
    assert read("amg_build_s", _run()) is None  # the set-up may be gone
