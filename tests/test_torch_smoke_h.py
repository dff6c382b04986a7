"""Phase H of ``chip_smoke.py`` (the domain-decomposed solve) on the CPU
at small sizes: H1 on a refined 6^3 box through the CLI, H2 on its system
at P = 4 and 8, H3 on a refined 5^3 box, H4 on a 6^3 box's file.

The smoke's own checks run as on the card (the launch counts are the
card's only), against reference numbers computed here as the main process
computes them from paths C, D1 and F3: the single-device CG+AMG count,
the unfused Jacobi-CG count and its f32 floor, the single-device matrix
test's eigenvalue.  On the CPU every wrapper runs its plain version, so
the kernel comparisons agree exactly.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from domain_decomposed_pde_solver_tpu_torch import SteadyHeatSolver
from domain_decomposed_pde_solver_tpu_torch.cli.matrix_test import main as mt
from domain_decomposed_pde_solver_tpu_torch.io import (
    box_mesh,
    refine_uniform,
    write_exodus,
)
from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
from domain_decomposed_pde_solver_tpu_torch.solvers import (
    cg_solve,
    jacobi_preconditioner,
)

torch.set_num_threads(1)

CELLS, SMALL_CELLS, BOX = 6, 5, 6


@pytest.fixture(scope="module")
def run_h(tmp_path_factory):
    out = tmp_path_factory.mktemp("phase_h")
    cpu = torch.device("cpu")
    solver = SteadyHeatSolver(
        refine_uniform(box_mesh(CELLS, CELLS, CELLS, "TETRA4"), 1),
        dtype=torch.float32, precond="amg", device=cpu)
    _u, rc = solver.solve(tol=1e-6, maxiter=200)
    sy, A = solver.system, solver.operator
    b = A.put_vector(sy.b, dtype=torch.float32)
    rd = cg_solve(A, b, torch.zeros_like(b), precond=jacobi_preconditioner(A),
                  tol=chip_smoke.PCG_TOL, maxiter=chip_smoke.PCG_MAXITER)
    u_ref, _k = chip_smoke.host_cg_f64(sy.A, sy.b)
    exo = out / "box.exo"
    write_exodus(str(exo), box_mesh(BOX, BOX, BOX, "TETRA4"))
    rep = {}
    assert mt(["--input", str(exo), "--cpu"], report=rep) == 0
    refs = dict(c_iterations=rc.iterations, d1_iterations=rd.iterations,
                d1_floor=chip_smoke.f32_floor(sy.A, u_ref, sy.b),
                f3_eigenvalue=rep["result"].eigenvalue)
    run = chip_smoke.phase_h(cpu, _kernels.KERNELS, refs, cells=CELLS,
                             small_cells=SMALL_CELLS, exo=exo, out=out)
    return run, refs


def test_phase_h_passes_its_checks_on_the_cpu(run_h):
    run, refs = run_h
    rec = chip_smoke.phase_h_record(run)
    json.dumps(rec)  # what the smoke's record line prints of it
    assert rec["H1"]["dof"] == SteadyHeatSolver(
        refine_uniform(box_mesh(CELLS, CELLS, CELLS, "TETRA4"), 1),
        device="cpu").system.n_free
    assert set(rec["H2"]) == {"4", "8"}
    assert {"solve.partition", "solve.plan", "solve.precond"} <= set(
        rec["H1"]["phases_s"])
    for P_, r in rec["H2"].items():
        assert r["storage"] == "bfloat16"
        assert abs(r["jacobi"]["iterations"] - refs["d1_iterations"]) <= 2
    four = rec["H2"]["4"]
    assert set(four["schwarz"]) == {"one-level", "two-level"}
    assert abs(four["halo_amg"]["iterations"] - rec["H1"]["iterations"]) <= 2
    assert rec["H3"]["host_relres"] <= 1.5e-8
    assert abs(rec["H4"]["eigenvalue"] - refs["f3_eigenvalue"]) <= 1e-8 * abs(
        refs["f3_eigenvalue"])
    # The plain versions on the CPU: every comparison agrees exactly.
    assert run["H2"]["errs"] == {"sell_spmv": 0.0}
    assert set(run["H2"]["replays"]) == {"H2 jacobi P=4", "H2 jacobi P=8",
                                         "H2 halo-amg P=4"}
    launches = chip_smoke.phase_h_launches(rec, "sell_spmv")
    assert set(launches) >= {"H1", "H2 jacobi P=4", "H3", "H4"}


def test_phase_h_replays_repeat_the_counted_solves(run_h):
    run, _refs = run_h
    fn, _counts = run["H2"]["replays"]["H2 jacobi P=8"]
    again = fn()
    assert again.iterations == run["H2"]["parts"][8]["jacobi"]["iterations"]
    _x, rh = run["H2"]["replays"]["H2 halo-amg P=4"][0]()
    assert rh.iterations == run["H2"]["parts"][4]["halo_amg"]["iterations"]
    assert np.isfinite(_x).all()
