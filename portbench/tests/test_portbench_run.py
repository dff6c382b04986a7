"""A run of each cell on the CPU at a small size, skipping only the
harness's look for a card: the result's last line, ``correct`` false
under the faults the cells can have, the controls failing the limits,
and the command refusing to run without a card."""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import harness
from test_portbench_layout import tiny_root

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = ["tet833k.sweep", "box10m.refine", "box10m.cg"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("pb"))


def run(root, cell, trace=False, seconds=0.4, seed=2**31 + 9):
    return harness.run_cell(harness.load_cell(cell, root), seed, seconds,
                            trace, "cpu", time.perf_counter(), root)


@pytest.mark.parametrize("cell", CELLS)
def test_last_line_shape(root, cell, capsys):
    out = run(root, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[:3] == ["correct", "attempted", "failed"]
    assert list(out)[-1] == "checks"
    c = harness.load_cell(cell, root)
    # the CPU has no trace: an end-to-end metric from the device's is left out
    assert set(out["metrics"]) == {m["name"] for m in c.end_to_end
                                   if m["source"] == "host_clock"}
    assert "setup_s" in out["metrics"]
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    capsys.readouterr()
    harness.print_result(out)
    captured = capsys.readouterr()
    assert json.loads(captured.out.strip().splitlines()[-1]) == json.loads(
        json.dumps(out))
    err = captured.err.strip().splitlines()
    assert [line.split()[1] for line in err[-len(out["checks"]):]] == list(
        out["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line_has_per_layer_metrics(root, cell):
    out = run(root, cell, trace=True)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    names = {m["name"] for m in spec["per_layer"]
             if cell in m.get("workloads", [cell])}
    # the CPU has no trace: the readers that need one read nothing
    assert {"iters_per_answer", "iters_per_answer.sweep"} & set(out["metrics"])
    assert set(out["metrics"]) <= names
    assert "breakdown" not in out  # no device trace on the CPU


def _state_unchanged(monkeypatch):
    """Every solve hands back its start: the last answer, unchanged."""
    from domain_decomposed_pde_solver_tpu_torch.solvers import cg, mixed

    def cg_solve(A, b, x0, **kw):
        return cg.CGResult(x=x0, iterations=1, relres=0.0, converged=True)

    def refine(A, b, x0=None, **kw):
        x = np.zeros(A.n_rows) if x0 is None else np.array(x0)
        return mixed.MixedSolveResult(x=x, refinements=1, inner_iterations=1,
                                      relres=0.0, converged=True)

    monkeypatch.setattr(cg, "cg_solve", cg_solve)
    monkeypatch.setattr(mixed, "iterative_refinement_solve", refine)


def _answer_altered(monkeypatch):
    """One value of every answer changed by 1 % where it is fetched."""
    from domain_decomposed_pde_solver_tpu_torch.ops import bsg, stencil_kernel

    for cls in (bsg.BSGMatrix, stencil_kernel.PadStencilOperator):
        inner = cls.get_vector

        def get_vector(self, xp, inner=inner):
            x = np.array(inner(self, xp))
            x[x.size // 3] *= 1.01
            return x

        monkeypatch.setattr(cls, "get_vector", get_vector)


@pytest.mark.parametrize("fault", [_state_unchanged, _answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run(root, cell)
    assert not out["correct"] and out["failed"] >= 1
    assert out["checks"]["relres_max"]["value"] > out["checks"][
        "relres_max"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limit(root, cell):
    from portbench import control

    c = harness.load_cell(cell, root)
    res = control.readings(c, [3, 2**31 + 3, 40], 0.3, "cpu")
    limit = c.limits["relres_limit"]
    assert res["lower"] < limit < res["upper"]
    assert all(s["unconverged"] == 0 for s in res["seeds"])


def test_no_card_no_result(tmp_path):
    p = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "tet833k.sweep", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's folder:
    the program is missing (or, here, the card), so no result."""
    import shutil

    d = tmp_path / "alone"
    shutil.copytree(ROOT / "portbench", d / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", d)
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "box10m.cg",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=d, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_listed_metric_that_reads_nothing_fails_a_traced_run(tmp_path):
    root = tiny_root(tmp_path)
    (root / "portbench" / "metrics" / "reads_nothing.py").write_text(
        "def read(run):\n    return None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "reads_nothing", "unit": "ms",
                              "better": "lower", "source": "program_span",
                              "layer": "test", "moves": "answers_per_s",
                              "workloads": ["box10m.cg"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("box10m.cg", root)
    rec = harness.Record({100: 1.0, 1000: 2.0}, 5.0, 4.0, None, 3, True)
    run = harness.RunRecord(cell, [rec], 1.0, {"amg_setup": 1.0}, None, {},
                            {"n_free": 1, "nnz": 1}, None)
    got = harness.read_per_layer(cell, run, root, required=False)
    assert "reads_nothing" not in got and "iters_per_answer" in got
    with pytest.raises(harness.MissingMetrics, match="reads_nothing"):
        harness.read_per_layer(cell, run, root, required=True)


def _run_record(cell, records, failed=frozenset(), trace=None):
    return harness.RunRecord(cell, records, 2.0, {}, trace, {},
                             {"n_free": 1, "nnz": 1}, None, failed)


def test_the_host_clock_metrics_and_their_per_layer_copies_agree(root):
    """``answers_per_s.sweep`` and ``answer_ms_p95.sweep`` read a run as
    the end-to-end ``answers_per_s`` and ``answer_ms_p95`` do: failed
    answers left out of the rate and counted as the longest in the tail."""
    cell = harness.load_cell("tet833k.sweep", root)
    recs = [harness.Record({100: 1.0}, ms, None, None, 3, True)
            for ms in (10.0, 20.0, 30.0, 40.0)]
    run = _run_record(cell, recs, frozenset({0}))
    assert harness.answer_rate(run) == 1.5
    assert harness.answer_p95(run) == harness.p95([40.0, 20.0, 30.0, 40.0])
    got = harness.read_per_layer(cell, run, root, required=False)
    assert got["answers_per_s.sweep"]["value"] == 1.5
    assert got["answer_ms_p95.sweep"]["value"] == harness.answer_p95(run)
    assert got["iters_per_answer.sweep"]["value"] == 3.0


def test_device_time_per_answer_from_a_trace_of_the_device_alone(
        root, monkeypatch):
    """The device's intervals are merged (overlaps once, ranges of host
    spans and of collectives left out) and shared over the answers; with
    no trace the metric reads nothing, which fails an untraced run on the
    card."""
    from portbench import tracing

    from test_portbench_group import _Event

    events = [
        _Event("pb.window", 0, 1000),
        _Event("nccl:all_reduce", 0, 900),
        _Event("sell_spmv_kernel", 100, 400),
        _Event("Memcpy HtoD (Pinned -> Device)", 300, 500),
        _Event("vectorized_elementwise_kernel", 700, 800),
        _Event("cudaLaunchKernel", 650, 660, device=False, corr=3),
    ]
    monkeypatch.setattr(tracing, "_events", lambda prof: events)
    tr = tracing.reduce_device(None)
    assert tr.busy_ns == 500 and tr.window_ns == (100, 800)
    assert not tr.kernels and not tr.spans
    cell = harness.load_cell("tet833k.sweep", root)
    assert harness.device_timed(cell)
    assert not harness.device_timed(harness.load_cell("box10m.cg", root))
    recs = [harness.Record({100: 1.0}, 5.0, None, None, 3, True)] * 4
    own = [m for m in cell.end_to_end if m["name"] == "device_ms_per_answer"]
    got = harness.read_per_layer(cell, _run_record(cell, recs, trace=tr),
                                 root, required=True, listed=own)
    assert got["device_ms_per_answer"]["value"] == 500 / 1e6 / 4
    with pytest.raises(harness.MissingMetrics, match="device_ms_per_answer"):
        harness.read_per_layer(cell, _run_record(cell, recs), root,
                               required=True, listed=own)
    monkeypatch.setattr(tracing, "_events", lambda prof: events[:2])
    assert tracing.reduce_device(None) is None
