"""The four-card cell ``box40m.refine.x4`` on the CPU: its system
(``systems/slab_refine.py``) on a copy of ``box40m`` cut to 90 cubed
cells, run over four CPU ranks through ``test_portbench_group.py``'s own
launcher and in one process holding the four slabs, against the
lattice reference; and its five readers (``collectives_per_answer``,
``comm_mb``, ``comm_ms``, ``nccl_device_ms``, ``k3_roofline.x4``) on a
synthetic run, each reading nothing (None) without the program's
recorder or without a trace."""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import test_portbench_group
from domain_decomposed_pde_solver_tpu_torch.utils.timers import Recorder
from portbench import harness
from portbench.metrics import _program
from portbench.metrics._roofline import stencil_bytes
from portbench.reference.heat import reference_for, round_to_float16
from portbench.tracing import KernelEvent, Spans, Trace
from test_portbench_layout import multicard_root

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "box40m.refine.x4"
# The least cube whose free grid (89 x 91 x 91) takes four z-slabs under
# the slab rule at the kernel's 8-layer blocks: 30, 30, 30 and 1 layers.
N = 90
TEMPS = {100: 250.0, 1000: 820.0}


def _cut_root(tmp_path):
    root = multicard_root(tmp_path, 4)
    p = root / "portbench" / "configs" / "box40m.json"
    c = json.loads(p.read_text())
    c["mesh"]["cells"] = [N] * 3
    p.write_text(json.dumps(c))
    return root


def test_four_cpu_ranks_over_gloo_end_correct(tmp_path):
    root = _cut_root(tmp_path)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(root), str(ROOT)]))
    p = subprocess.run(
        [sys.executable, test_portbench_group.__file__, "--root", str(root),
         "--workload", CELL, "--seed", str(2**31 + 40), "--seconds", "1.0",
         "--devices", "cpu,cpu,cpu,cpu"],
        capture_output=True, text=True, cwd=root, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["relres_max"]["value"] <= 1e-8
    dev = out["device"]
    # Four reports, one a rank; the CPU holds no card's memory, so none
    # counts as a card.
    assert dev["platform"] == "cpu" and dev["count"] == 0
    assert dev["memory_peak_bytes_per_card"] == [0, 0, 0, 0]
    line = [s for s in p.stderr.splitlines() if "answers per rank" in s][-1]
    assert json.loads(line.split(": ", 1)[1]) == [out["attempted"]] * 4
    assert sum("started rank" in s for s in p.stderr.splitlines()) == 3
    assert set(out["metrics"]) == {"answers_per_s", "answer_ms_p95",
                                   "setup_s"}


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The cut cell's session in one process holding the four slabs, and
    its reference."""
    cell = harness.load_cell(CELL, _cut_root(tmp_path_factory.mktemp("x4")))
    session = harness.open_session(cell, torch.device("cpu"), Spans(False))
    yield cell, session, reference_for(cell.config)
    session.close()


def test_four_slabs_in_one_process_meet_the_limit(one_process):
    """The refinement over four slabs agrees with the reference to the
    cell's limit; the same answer held in float16 does not, nor does the
    cell's control, f32 CG to 1e-6 on the same set-up."""
    cell, session, ref = one_process
    plan = session.samg.plan
    assert plan.nparts == 4 and list(plan.zlims[:, 0, 1]) == [30, 30, 30, 1]
    limit = cell.limits["relres_limit"]
    session.prepare(TEMPS)
    ans = session.request(TEMPS)
    assert ans.converged and ans.solve_ms > 0 and ans.copy_ms > 0
    assert ref.relres(ans.x, TEMPS) <= limit
    assert ref.relres(round_to_float16(ans.x), TEMPS) > 10 * limit
    control = cell.limits["control"]
    session.use(dict(cell.traffic, **{k: v for k, v in control.items()
                                       if k != "kind"}))
    session.prepare(TEMPS)
    ctl = session.request(TEMPS)
    assert ctl.converged and ref.relres(ctl.x, TEMPS) > limit
    session.use(cell.traffic)


def _state_unchanged(monkeypatch):
    """Every solve hands back its start: the last answer, unchanged."""
    from domain_decomposed_pde_solver_tpu_torch.parallel import slabpadmixed
    from domain_decomposed_pde_solver_tpu_torch.solvers import mixed

    def refine(samg, pad_op=None, b=None, x0=None, **kw):
        x = np.zeros(b.size) if x0 is None else np.array(x0)
        return mixed.MixedSolveResult(
            x=x, refinements=1, inner_iterations=1, relres=0.0,
            converged=True, timings={"stage_ms": 0.0, "sweeps_ms": 0.0,
                                     "fetch_ms": 0.0})

    monkeypatch.setattr(slabpadmixed, "slab_pad_amg_refine_solve", refine)


def _answer_altered(monkeypatch):
    """One value of every answer changed by 1 % where it is gathered."""
    from domain_decomposed_pde_solver_tpu_torch.parallel import slabpad

    inner = slabpad.SlabPadPlan.gather_vector

    def gather_vector(self, x_parts):
        x = np.array(inner(self, x_parts))
        x[x.size // 3] *= 1.01
        return x

    monkeypatch.setattr(slabpad.SlabPadPlan, "gather_vector", gather_vector)


@pytest.mark.parametrize("fault", [_state_unchanged, _answer_altered])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault, monkeypatch):
    fault(monkeypatch)
    root = _cut_root(tmp_path)
    out = harness.run_cell(harness.load_cell(CELL, root), 2**31 + 41, 0.3,
                           False, "cpu", time.perf_counter(), root)
    assert not out["correct"] and out["failed"] >= 1
    assert out["checks"]["relres_max"]["value"] > out["checks"][
        "relres_max"]["limit"]


# --- the readers, on a synthetic run ---------------------------------------

W0, W1 = 10_000, 20_000
NEW = ["collectives_per_answer", "comm_mb", "comm_ms", "nccl_device_ms",
       "k3_roofline.x4"]
N_FREE = 41_182_304
PEAK = 3.35e12


def _span(rec, name, start, end, parent=None, counts=None):
    s = rec.record(name, start, end)
    if parent is not None:
        s.parent, s.request = parent.id, parent.request
    s.counts = counts
    return s


def _request(rec, t):
    """One answer's collectives from ``t``: a dot (its gather inside), a
    halo exchange and an all-to-all."""
    req = _span(rec, "request", t, t + 1000)
    dot = _span(rec, "comm.dot", t + 10, t + 110, req)
    _span(rec, "comm.gather", t + 20, t + 100, dot,
          {"collectives": 1, "comm_bytes": 1_000_000})
    _span(rec, "comm.halo", t + 200, t + 230, req,
          {"collectives": 1, "comm_bytes": 2_000_000})
    _span(rec, "comm.exchange", t + 300, t + 310, req,
          {"collectives": 1, "comm_bytes": 500_000})


@pytest.fixture
def rec(monkeypatch):
    r = Recorder()
    monkeypatch.setattr(_program, "recorder", lambda: r)
    _request(r, 5_000)  # before the window
    _request(r, W0 + 1_000)
    _request(r, W0 + 3_000)
    _request(r, W1 + 1_000)  # after it
    return r


def _kernels():
    ms = 1_000_000
    return [
        KernelEvent("ncclDevKernel_AllGather_RING_LL", W0, W0 + 2 * ms, 1),
        KernelEvent("pad_stencil_kernel<float>", W0 + 3 * ms, W0 + 4 * ms,
                    W0 + 150),
        KernelEvent("pad_stencil_kernel<double>", W0 + 5 * ms, W0 + 7 * ms,
                    W0 + 250),
        KernelEvent("ncclDevKernel_SendRecv", W0 + 8 * ms, W0 + 9 * ms, 2),
        KernelEvent("vectorized_elementwise_kernel", W0, W0 + ms, 3),
    ]


def _run(trace=True, n_answers=2):
    cell = harness.load_cell(CELL, ROOT)
    rec = harness.Record(TEMPS, 5.0, None, None, 14, True)
    spans = [("fine.k3.4", W0 + 100, W0 + 200),
             ("fine.k3.8", W0 + 200, W0 + 300)]
    tr = (Trace((W0, W1), _kernels(), 1, {}, {}, spans) if trace else None)
    return harness.RunRecord(cell, [rec] * n_answers, 1.0, {}, tr,
                             {"k3": "pad_stencil_kernel"},
                             {"n_free": N_FREE, "nnz": 1}, PEAK)


def read(name, run):
    return harness.load_reader(name)(run)


def test_the_readers_take_the_window_per_answer(rec):
    run = _run()
    assert read("collectives_per_answer", run) == 3
    assert read("comm_mb", run) == pytest.approx(3.5)
    # gather 80 ns + halo 30 + exchange 10; the dot that holds the
    # gather is not counted again
    assert read("comm_ms", run) == pytest.approx(120e-6)
    assert read("nccl_device_ms", run) == pytest.approx(1.5)
    # one card's quarter of the free rows, x and y once, f32 then f64
    least = (stencil_bytes(N_FREE // 4, 4) + stencil_bytes(N_FREE // 4, 8))
    assert read("k3_roofline.x4", run) == pytest.approx(
        100 * least / PEAK / 3e-3)


def test_a_window_without_collectives_reads_zero(monkeypatch):
    r = Recorder()
    monkeypatch.setattr(_program, "recorder", lambda: r)
    _span(r, "request", W0 + 1_000, W0 + 2_000)
    run = _run()
    assert read("collectives_per_answer", run) == 0
    assert read("comm_mb", run) == 0
    assert read("comm_ms", run) == 0


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_without_a_trace(rec, name):
    assert read(name, _run(trace=False)) is None


@pytest.mark.parametrize("name", ["collectives_per_answer", "comm_mb",
                                  "comm_ms"])
def test_nothing_to_read_without_the_recorder(monkeypatch, name):
    monkeypatch.setattr(_program, "recorder", lambda: None)
    assert read(name, _run()) is None
