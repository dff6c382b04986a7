"""Phase I of ``chip_smoke.py`` (the structured slab engines) on the CPU
at small sizes: I1 and I2 on a box of free grid 7 x 9 x 31 over two slabs
of 30 layers (bz 8, brick 6: the slab rule needs mz > 30 at P = 2, the
card's run has 101 over four), I3 on ``structured_box_system(26, 26,
26)`` over two slabs of 18 layers (bz 4).

The smoke's own checks run as on the card (the launch counts are the
card's only), against reference numbers computed here as the main process
computes them from paths A and G: the single-device refinement's sweeps
and inner iterations on the same file, and the single-device CG+AMG count
on the 26^3 box.  On the CPU every window product runs its plain version,
so the kernel comparisons agree exactly.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from domain_decomposed_pde_solver_tpu_torch.cli.solve import main
from domain_decomposed_pde_solver_tpu_torch.io import box_mesh, write_exodus
from domain_decomposed_pde_solver_tpu_torch.models.structured import (
    structured_box_parts,
    structured_box_system,
)
from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
    pad_stencil_from_parts,
)
from domain_decomposed_pde_solver_tpu_torch.solvers import (
    cg_solve,
    smoothed_aggregation_setup,
)

torch.set_num_threads(1)

N10, PARTS = 26, 2


@pytest.fixture(scope="module")
def run_i(tmp_path_factory):
    out = tmp_path_factory.mktemp("phase_i")
    cpu = torch.device("cpu")
    exo = out / "box.exo"
    write_exodus(str(exo), box_mesh(8, 8, 30, "TETRA4"))
    rep = {}
    assert main(["--input", str(exo), "--solution", str(out / "a.exo"),
                 "--cpu", "--dtype", "float64", "--precond", "amg",
                 "--no-snapshots", "--tolerance", "1e-8"], report=rep) == 0
    sy = structured_box_system(N10, N10, N10, "TETRA4")
    A = pad_stencil_from_parts(
        structured_box_parts(N10, N10, N10, "TETRA4", device=cpu)["parts"],
        device=cpu)
    M = smoothed_aggregation_setup(sy.A, dtype=torch.float32,
                                   grid_dims=(N10 - 1, N10 + 1, N10 + 1),
                                   fine_operator=A)
    b = A.put_vector((sy.b / np.abs(sy.b).max()).astype(np.float32))
    rg = cg_solve(A, b, torch.zeros_like(b), precond=M, tol=1e-6,
                  maxiter=100)
    refs = dict(a_sweeps=rep["mixed"].refinements,
                a_inner=rep["mixed"].inner_iterations, g_cg=rg.iterations)
    run = chip_smoke.phase_i(cpu, _kernels.KERNELS, refs, exo=exo, n10=N10,
                             parts=PARTS, out=out)
    return run, refs


def test_phase_i_passes_its_checks_on_the_cpu(run_i):
    run, refs = run_i
    rec = chip_smoke.phase_i_record(run)
    json.dumps(rec)  # what the smoke's record line prints of it
    i1 = rec["I1"]
    assert i1["dof"] == 7 * 9 * 31 and i1["L"] == 30 and i1["bz"] == 8
    assert i1["zlims"] == [30, 1]
    assert i1["sweeps"] == refs["a_sweeps"]
    assert {"solve.precond", "solve.iterate"} <= set(i1["phases_s"])
    assert set(rec["I2"]["solves"]) == {
        "slab-pad AMG f32", "slab-pad Jacobi f32", "slab DIA AMG f64",
        "slab DIA Jacobi f32", "slab DIA brick-Schwarz f32"}
    i3 = rec["I3"]
    assert i3["dof"] == (N10 - 1) * (N10 + 1) ** 2
    assert i3["L"] == 18 and i3["bz"] == 4 and i3["zlims"] == [18, 9]
    assert abs(i3["cg"]["iterations"] - refs["g_cg"]) <= 1
    assert i3["host_relres"] <= 1.5e-8
    # The plain versions on the CPU: every window comparison agrees exactly.
    assert run["errs"] == {"pad_stencil": 0.0}
    assert set(rec["I2"]["window_errs"]) == {
        f"part {p} {t}" for p in range(PARTS)
        for t in ("float32", "float64")}
    launches = chip_smoke.phase_i_launches(rec, "pad_stencil")
    assert set(launches) >= {"I1", "I2 slab-pad AMG f32", "I3 cg",
                             "I3 refine"}


def test_phase_i_replays_repeat_the_counted_solves(run_i):
    run, _refs = run_i
    fn, _counts = run["I2"]["replays"]["I2 slab-pad AMG f32"]
    _x, r = fn()
    assert r.iterations == run["I2"]["solves"]["slab-pad AMG f32"][
        "iterations"]
    fn, _counts = run["I3"]["replays"]["I3 refine"]
    mr = fn()
    assert mr.refinements == run["I3"]["refine"]["sweeps"]
    assert np.isfinite(mr.x).all()


def test_window_bound_counts_the_window(run_i):
    """Kernel 3's per-part bound: x on real nodes and halo layers that hold
    real nodes, corr on real nodes, y on the owned slots."""
    run, _refs = run_i
    op = run["I3"]["op"]
    mx, my, _ = op.dims
    layer = mx * my
    ms0, by0, b0 = chip_smoke._window_bound(op, 0, 4)
    assert by0 == "bytes"
    assert b0 == (18 + 1) * layer * 4 + 18 * layer * 2 + op.n_pad * 4
    _ms1, _by1, b1 = chip_smoke._window_bound(op, 1, 8)
    assert b1 == (9 + 1) * layer * 8 + 9 * layer * 2 + op.n_pad * 8
    assert ms0 == pytest.approx(b0 / chip_smoke.HBM_BYTES_PER_S * 1e3)
