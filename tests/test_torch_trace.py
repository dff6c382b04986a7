"""The port's span-and-counter recorder (``utils/timers.py``): nesting,
parent and request ids, self times, counters on the innermost span, the
ring's bound and its drop count, threads; its clock against
``torch.profiler``'s and the absence of any profiler event of its own;
the spans and counters of one ``SteadyHeatSolver.solve``, of the f64
refinement (whose ``MixedSolveResult.timings`` are its spans'), of the AMG
set-up (whose ``timings_out`` are its child spans'), of ``PhaseTimer`` and
in ``trace_to``'s file.

The ``cuda`` cases count the bytes of one put and one get of a sliced-ELL
and a pad-stencil operator on the card, and check that back-to-back puts
and fetches through page-locked buffers keep their own data; they skip
without one.  The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py
"""

import json
import os
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from domain_decomposed_pde_solver_tpu_torch import SteadyHeatSolver
from domain_decomposed_pde_solver_tpu_torch.io import box_mesh, refine_uniform
from domain_decomposed_pde_solver_tpu_torch.models import structured
from domain_decomposed_pde_solver_tpu_torch.ops.bsg import BSGMatrix
from domain_decomposed_pde_solver_tpu_torch.ops.ell import (
    fetch_vector,
    stage_vector,
)
from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
    pad_stencil_from_parts,
)
from domain_decomposed_pde_solver_tpu_torch.solvers.mixed import (
    iterative_refinement_solve,
)
from domain_decomposed_pde_solver_tpu_torch.solvers.precond.amg import (
    smoothed_aggregation_setup,
)
from domain_decomposed_pde_solver_tpu_torch.utils import timers
from domain_decomposed_pde_solver_tpu_torch.utils.timers import (
    RECORDER,
    PhaseTimer,
    Recorder,
    self_ns,
    trace_to,
)

BC = {100: 310.0, 1000: 520.0}


def _sleep_ns(ns):
    end = time.time_ns() + ns
    while time.time_ns() < end:
        pass


def _tree(spans, root):
    """The spans of ``root``'s request, by name."""
    return [s for s in spans if s.request == root.id]


def test_nesting_parent_and_request_ids():
    rec = Recorder()
    with rec.span("a") as a:
        with rec.span("b") as b:
            with rec.span("c") as c:
                pass
        with rec.span("d") as d:
            pass
    with rec.span("e") as e:
        pass
    assert [s.name for s in rec.spans()] == ["c", "b", "d", "a", "e"]
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (
        None, a.id, b.id, a.id, None)
    assert {s.request for s in (a, b, c, d)} == {a.id} and e.request == e.id
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns \
        <= d.start_ns <= d.end_ns <= a.end_ns <= e.start_ns


def test_self_time_is_the_duration_less_the_children():
    rec = Recorder()
    with rec.span("outer") as o:
        _sleep_ns(200_000)
        with rec.span("child") as c1:
            _sleep_ns(300_000)
        with rec.span("child") as c2:
            with rec.span("grandchild") as g:
                _sleep_ns(100_000)
    own = self_ns(rec.spans())
    assert own[o.id] == o.ns - c1.ns - c2.ns
    assert own[c2.id] == c2.ns - g.ns and own[g.id] == g.ns
    assert own[o.id] >= 200_000


def test_counters_land_on_the_innermost_span():
    rec = Recorder()
    rec.count("lost")  # outside every span: nothing
    with rec.span("outer") as o:
        rec.count("n", 2)
        with rec.span("inner") as i:
            rec.count("n", 3)
            rec.count("m")
        rec.count("n")
    assert o.counts == {"n": 3} and i.counts == {"n": 3, "m": 1}
    assert all("lost" not in (s.counts or {}) for s in rec.spans())


def test_the_ring_is_bounded_and_counts_what_it_drops():
    rec = Recorder(capacity=4)
    made = []
    for k in range(10):
        with rec.span(f"s{k}") as s:
            pass
        made.append(s)
    held = rec.spans()
    assert [s.name for s in held] == ["s6", "s7", "s8", "s9"]
    assert rec.dropped == 6
    since = rec.complete_since_ns
    assert since == made[6].end_ns
    assert all(s in held for s in made if s.start_ns > since)
    assert all(s.start_ns <= since for s in made[:6])
    assert Recorder().dropped == 0 and Recorder().complete_since_ns == 0


def test_threads_keep_their_own_stacks_and_lose_no_span():
    rec = Recorder()
    n_threads = max(2, (os.cpu_count() or 1) + 2)
    per = 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with rec.span("outer"):
                    with rec.span("inner"):
                        rec.count("n")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = rec.spans()
    assert len(spans) == 2 * per * n_threads and rec.dropped == 0
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "inner":
            p = by_id[s.parent]
            assert p.name == "outer" and p.thread == s.thread
            assert s.counts == {"n": 1} and p.counts is None


def _host_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU]


def test_spans_share_the_profilers_clock():
    """A span around a ``record_function`` range contains that range."""
    rec = Recorder()
    x = torch.randn(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(20):
            with rec.span(f"s{k}"):
                with record_function(f"r{k}"):
                    (x * 2).sum()
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in _host_events(prof) if e.name().startswith("r")}
    for s in rec.spans():
        r0, r1 = ranges["r" + s.name[1:]]
        assert s.start_ns <= r0 <= r1 <= s.end_ns, (s, r0, r1)


@pytest.fixture(scope="module")
def solver():
    mesh = refine_uniform(box_mesh(6, 6, 6, "TETRA4"), 1)
    s = SteadyHeatSolver(mesh, dtype=torch.float32, device="cpu")
    assert isinstance(s.operator, BSGMatrix) and s.operator.perm is not None
    s.solve(bc={100: 300.0, 1000: 500.0}, tol=1e-6, maxiter=200)
    return s


def test_the_program_adds_no_profiler_event(solver):
    """A profiled solve holds no user range: the program's spans stay out
    of the profiler's trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with RECORDER.span("outside"):
            solver.solve(bc=BC, tol=1e-6, maxiter=200)
    names = {s.name for s in RECORDER.spans()}
    assert {"request", "cg", "cg.iter"} <= names
    events = _host_events(prof)
    assert events
    assert not [e.name() for e in events if e.is_user_annotation()
                or e.name() in names]


def test_one_solve_records_its_tree(solver):
    u, res = solver.solve(bc={100: 700.0, 1000: 150.0}, tol=1e-6,
                          maxiter=200)
    spans = RECORDER.spans()
    (root,) = [s for s in spans if s.name == "request"][-1:]
    tree = _tree(spans, root)
    by_id = {s.id: s for s in tree}
    k = res.iterations
    assert res.converged and k >= 2
    assert Counter(s.name for s in tree) == {
        "request": 1, "request.rhs": 1, "request.put": 2, "cg": 1,
        "cg.iter": k, "cg.sync": k + 1, "request.get": 1}
    (cg,) = [s for s in tree if s.name == "cg"]
    for s in tree:
        if s.name in ("request.rhs", "request.put", "request.get", "cg"):
            assert s.parent == root.id
        elif s.name == "cg.iter":
            assert s.parent == cg.id
    syncs = [s for s in tree if s.name == "cg.sync"]
    assert sum(s.parent == cg.id for s in syncs) == 1
    iters = [s for s in tree if s.name == "cg.iter"]
    assert sorted(s.parent for s in syncs if s.parent != cg.id) == sorted(
        s.id for s in iters)
    # The children lie inside their parents, in order.
    for s in tree:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert [s.name for s in sorted(tree, key=lambda s: s.start_ns)][:4] == [
        "request", "request.rhs", "request.put", "request.put"]


def test_host_syncs_are_what_the_loop_and_the_fetches_read(solver):
    """Per solve: each stopping test, the residual and the verdict read as
    host values, the answer's fetch (a put reads nothing back: its
    permutation is applied on the device); on the CPU no byte crosses
    between host and card."""
    _u, res = solver.solve(bc={100: 200.0, 1000: 800.0}, tol=1e-6,
                           maxiter=200)
    spans = RECORDER.spans()
    root = [s for s in spans if s.name == "request"][-1]
    tree = _tree(spans, root)
    syncs = {}
    for s in tree:
        if s.counts:
            syncs[s.name] = syncs.get(s.name, 0) + s.counts.get(
                "host_syncs", 0)
            assert not {"h2d_bytes", "d2h_bytes", "pinned_bytes"} & set(
                s.counts)
    k = res.iterations
    assert syncs == {"cg.sync": k + 1, "cg": 2, "request.get": 1}


def test_a_solve_that_stops_at_maxiter_reads_no_test_after_the_last_pass(
        solver):
    _u, res = solver.solve(bc={100: 900.0, 1000: 100.0}, tol=1e-12,
                           maxiter=2, warm_start=False)
    spans = RECORDER.spans()
    tree = _tree(spans, [s for s in spans if s.name == "request"][-1])
    names = Counter(s.name for s in tree)
    assert res.iterations == 2 and not res.converged
    assert names["cg.iter"] == 2 and names["cg.sync"] == 2
    assert names["request.put"] == 1  # a cold start puts b alone


@pytest.fixture(scope="module")
def box():
    n = 10
    sy = structured.structured_box_system(n, n, n)
    parts = structured.structured_box_parts(n, n, n, device="cpu")
    A = pad_stencil_from_parts(parts["parts"], device="cpu")
    tm = {}
    M = smoothed_aggregation_setup(
        sy.A, dtype=torch.float32, grid_dims=(n - 1, n + 1, n + 1),
        fine_operator=A, timings_out=tm)
    return sy, A, M, tm, RECORDER.spans()


def test_amg_setup_phases_are_child_spans(box):
    _sy, _A, _M, tm, spans = box
    root = [s for s in spans if s.name == "setup.amg"][-1]
    kids = [s for s in spans if s.parent == root.id]
    assert kids and all(s.name.startswith("setup.amg.") for s in kids)
    sums = {}
    for s in kids:
        key = s.name[len("setup.amg."):]
        sums[key] = sums.get(key, 0.0) + s.seconds
    assert sums == tm
    assert {"diag_probe", "coarse"} <= set(tm)
    assert sum(s.ns for s in kids) <= root.ns


def test_refinement_timings_are_its_spans(box):
    sy, A, M, _tm, _spans = box
    x0 = np.random.default_rng(3).uniform(0, 1, sy.n_free)
    mr = iterative_refinement_solve(
        sy.A, sy.b, x0, tol=1e-8, inner_tol=1e-6, inner_maxiter=100,
        precond=M, operator=A, device_residual=True)
    assert mr.converged and mr.refinements >= 1
    spans = RECORDER.spans()
    root = [s for s in spans if s.name == "refine"][-1]
    tree = _tree(spans, root)
    phases = {s.name: s for s in tree if s.parent == root.id}
    assert set(phases) == {"refine.stage", "refine.sweeps", "refine.fetch"}
    assert mr.timings == {"stage_ms": phases["refine.stage"].ms,
                          "sweeps_ms": phases["refine.sweeps"].ms,
                          "fetch_ms": phases["refine.fetch"].ms}
    assert phases["refine.stage"].end_ns <= phases["refine.sweeps"].start_ns
    assert phases["refine.sweeps"].end_ns <= phases["refine.fetch"].start_ns
    names = Counter(s.name for s in tree)
    assert names["cg"] == mr.refinements
    assert names["cg.iter"] == mr.inner_iterations
    assert names["request.put"] == 2 and names["request.get"] == 1
    syncs = sum((s.counts or {}).get("host_syncs", 0) for s in tree)
    # The first residual, each sweep's residual, each CG's tests and its
    # two reads, the fetch.
    assert syncs == 1 + mr.refinements + (
        mr.inner_iterations + 3 * mr.refinements) + 1


def test_phase_timer_report_keeps_its_format():
    t = PhaseTimer()
    with t.phase("read"):
        _sleep_ns(50_000)
    with t.phase("solve.iterate"):
        pass
    with t.phase("read"):
        pass
    lines = t.report().splitlines()
    assert [line.split()[0] for line in lines] == ["read", "solve.iterate"]
    for line, name in zip(lines, t.totals):
        assert line == f"{name:<13}  {t.totals[name]:9.3f}s  x{t.counts[name]}"
    reads = [s for s in RECORDER.spans() if s.name == "read"][-2:]
    assert t.totals["read"] == sum(s.seconds for s in reads)
    assert t.counts == {"read": 2, "solve.iterate": 1}


def test_phase_timer_counts_a_phase_that_raises():
    t = PhaseTimer()
    with pytest.raises(RuntimeError):
        with t.phase("boom"):
            raise RuntimeError("x")
    assert t.counts == {"boom": 1} and t.totals["boom"] >= 0


def test_trace_to_writes_the_spans_into_its_file(tmp_path, solver):
    with RECORDER.span("before"):
        pass
    with trace_to(str(tmp_path)):
        _u, res = solver.solve(bc={100: 450.0, 1000: 450.0}, tol=1e-6,
                               maxiter=200)
    (path,) = tmp_path.glob("trace.*.json")
    trace = json.loads(path.read_text())
    ours = [e for e in trace["traceEvents"] if e.get("cat") == "program"]
    names = Counter(e["name"] for e in ours)
    assert names["request"] == 1 and names["cg.iter"] == res.iterations
    assert "before" not in names
    base = int(trace.get("baseTimeNanoseconds", 0))
    req = [s for s in RECORDER.spans() if s.name == "request"][-1]
    (ev,) = [e for e in ours if e["name"] == "request"]
    assert ev["ts"] == (req.start_ns - base) / 1e3
    assert ev["dur"] == req.ns / 1e3 and ev["args"]["id"] == req.id
    # On the file's time base: the profiler's own events of the solve lie
    # inside the request's span.
    inside = [e for e in trace["traceEvents"] if e.get("ph") == "X"
              and e.get("cat") != "program"
              and ev["ts"] <= e["ts"] <= ev["ts"] + ev["dur"]]
    assert inside


def test_the_ring_holds_a_window_of_the_busiest_cell():
    assert timers.RING_SPANS >= 4 * 19_000
    assert RECORDER._ring.maxlen == timers.RING_SPANS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _counts_of(fn):
    with RECORDER.span("probe") as s:
        out = fn()
    totals = Counter()
    for x in RECORDER.spans():
        if x.request == s.request:
            totals.update(x.counts or {})
    return out, totals


@pytest.mark.cuda
def test_bsg_put_and_get_bytes_on_the_card(card):
    """A put uploads the n real entries through a page-locked buffer and
    scatters them on the card: no fetch of the permutation, no sync."""
    mesh = refine_uniform(box_mesh(6, 6, 6, "TETRA4"), 1)
    s = SteadyHeatSolver(mesh, dtype=torch.float32, device=card)
    A = s.operator
    assert isinstance(A, BSGMatrix) and A.perm is not None
    n = A.n_rows
    b = s.rhs_for(BC)
    xd, put = _counts_of(lambda: A.put_vector(b, dtype=torch.float32))
    assert put == {"h2d_bytes": n * 4, "pinned_bytes": n * 4}
    x, get = _counts_of(lambda: A.get_vector(xd))
    assert get == {"d2h_bytes": n * 4, "pinned_bytes": n * 4,
                   "host_syncs": 1}
    np.testing.assert_array_equal(x, b.astype(np.float32))


@pytest.mark.cuda
def test_pad_stencil_put_and_get_bytes_on_the_card(card):
    """A put uploads the real entries through a page-locked buffer and
    pads them on the card."""
    n = 12
    sy = structured.structured_box_system(n, n, n)
    parts = structured.structured_box_parts(n, n, n, device=card)
    A = pad_stencil_from_parts(parts["parts"], device=card)
    xd, put = _counts_of(lambda: A.put_vector(sy.b, dtype=torch.float32))
    assert put == {"h2d_bytes": sy.n_free * 4, "pinned_bytes": sy.n_free * 4}
    x, get = _counts_of(lambda: A.get_vector(xd))
    assert get == {"d2h_bytes": sy.n_free * 4, "pinned_bytes": sy.n_free * 4,
                   "host_syncs": 1}
    np.testing.assert_array_equal(x, sy.b.astype(np.float32))


@pytest.mark.cuda
def test_back_to_back_puts_and_fetches_keep_their_own_buffers(card):
    """Puts made one after the other with no sync between them, as the
    refinement stages b and then x0, each land their own input; an answer
    already fetched does not change with the next fetch."""
    n = 12
    parts = structured.structured_box_parts(n, n, n, device=card)
    A = pad_stencil_from_parts(parts["parts"], device=card)
    rng = np.random.default_rng(11)
    xs = [rng.uniform(-1, 1, A.n_rows) for _ in range(2)]
    ds = [A.put_vector(x, dtype=torch.float64) for x in xs]
    # Large flat vectors as well, so that a buffer reused before its copy
    # had finished would show.
    big = [rng.uniform(-1, 1, 1 << 22) for _ in range(4)]
    bigd = [stage_vector(x, card, torch.float64) for x in big]
    got = [A.get_vector(d) for d in ds]
    for x, g in zip(xs, got):
        np.testing.assert_array_equal(g, x)
    for x, d in zip(big, bigd):
        np.testing.assert_array_equal(fetch_vector(d), x)
    again = A.get_vector(ds[1])
    np.testing.assert_array_equal(got[0], xs[0])
    np.testing.assert_array_equal(again, xs[1])
    assert not np.shares_memory(again, got[1])


@pytest.mark.cuda
def test_each_cg_iter_holds_its_launches_on_the_card(card):
    """On the card's trace: every kernel launched inside the CG loop was
    launched inside one ``cg.iter`` or the ``cg.sync`` before it, the same
    number per pass, and none between two passes."""
    mesh = refine_uniform(box_mesh(8, 8, 8, "TETRA4"), 1)
    s = SteadyHeatSolver(mesh, dtype=torch.float32, device=card)
    s.solve(bc=BC, tol=1e-6, maxiter=200)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _u, res = s.solve(bc={100: 900.0, 1000: 100.0}, tol=1e-6,
                          maxiter=200, warm_start=False)
        torch.cuda.synchronize()
    launches = sorted(e.start_ns() for e in _host_events(prof)
                      if e.name().startswith(("cudaLaunch", "cuLaunch")))
    spans = RECORDER.spans()
    root = [x for x in spans if x.name == "request"][-1]
    tree = _tree(spans, root)
    iters = sorted((x for x in tree if x.name == "cg.iter"),
                   key=lambda x: x.start_ns)
    assert len(iters) == res.iterations >= 2
    per = [sum(x.start_ns <= t <= x.end_ns for t in launches) for x in iters]
    assert per[0] > 0 and len(set(per)) == 1, per
    for a, b in zip(iters, iters[1:]):
        assert not [t for t in launches if a.end_ns < t < b.start_ns]
