"""The CLI's structured ``--partitions N --precond amg`` route: the port's
``cli/solve.py`` against the JAX package's on the same structured Exodus
file, both on the CPU (JAX on its 8 virtual devices with ``--x64``, the
port with ``--cpu``).

Off a TPU JAX takes, as the port does off a CUDA device: in f32 the global
AMG over lattice-stencil slabs (``build_slab_amg``); in f64 with
f32-exact values the refinement over pad-stencil slabs
(``slab_pad_amg_refine_solve``, kernel 3 in interpret mode in JAX, its
plain version in the port) when the slabs fit, else the global AMG over
slab DIA fine levels.  The free grid is 7 x 7 x 31: at brick 6 and bz 8
the pad slabs are 30 layers, so two parts fit and four do not (the f64
route then falls through to the slab DIA AMG on both sides).

The "Converged in N iterations" lines are equal.  The f64 slab DIA
solve's answers agree to 1e-10 relative (the same f64 solve summed in
another order); the refinement's to 1e-8, since its last sweep is an f32
CG solve whose rounding moves the answer by up to the condition number
times the f64 tolerance (1.1e-9 measured here), and each file's answer
has a host f64 relative residual within the tolerance; f32 answers agree
to 1e-4 (f32 rounding through CG's recurrence).
"""

import re

import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.cli.solve import main as j_main
from domain_decomposed_pde_solver_tpu_torch.cli.solve import main as p_main
from domain_decomposed_pde_solver_tpu_torch.io import (
    box_mesh,
    read_nodal_vars,
    write_exodus,
)
from torch_parity import relerr

torch.set_num_threads(1)

_CONVERGED = re.compile(r"^(Converged|DID NOT converge) in (\d+) iterations",
                        re.M)

# (dtype, parts, snapshots, the port's preconditioner, its fine level,
# the answers' agreement) per case.
CASES = {
    "f32-P2": ("float32", 2, False, "SlabAMG", "stencil", 1e-4),
    "f32-P2-snapshots": ("float32", 2, True, "SlabAMG", "stencil", 1e-4),
    "f32-P4": ("float32", 4, False, "SlabAMG", "stencil", 1e-4),
    "f64-P2-refine": ("float64", 2, False, "SlabPadAMG", "pad", 1e-8),
    "f64-P4-dia": ("float64", 4, False, "SlabAMG", "dia", 1e-10),
}


@pytest.fixture(scope="module")
def box_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("slab_cli") / "box.exo"
    write_exodus(str(path), box_mesh(8, 6, 30, "TETRA4"))  # free 7 x 7 x 31
    return path


def _run(main, exo, sol, args, capsys):
    rc = main(["--input", str(exo), "--solution", str(sol)] + args)
    text = capsys.readouterr().out
    m = _CONVERGED.search(text)
    assert m is not None, text
    return rc, m.group(0), read_nodal_vars(str(sol))


@pytest.mark.parametrize("case", sorted(CASES))
def test_structured_partitions_match_jax(box_file, tmp_path, capsys, case):
    dtype, nparts, snapshots, kind, fine, agree = CASES[case]
    tol = "1e-8" if dtype == "float64" else "1e-6"
    args = ["--partitions", str(nparts), "--precond", "amg", "--dtype",
            dtype, "--tolerance", tol, "--cpu"]
    if not snapshots:
        args.append("--no-snapshots")
    rep = {}
    rc_p, line_p, (_n, tp, vp) = _run(lambda a: p_main(a, report=rep),
                                      box_file, tmp_path / "p.exo", args,
                                      capsys)
    rc_j, line_j, (_m, tj, vj) = _run(j_main, box_file, tmp_path / "j.exo",
                                      args + ["--x64"], capsys)
    assert rc_p == rc_j == 0
    assert line_p == line_j
    np.testing.assert_array_equal(tp, tj)
    assert vp.shape == vj.shape
    np.testing.assert_array_equal(vp[0], vj[0])  # the boundary snapshot
    assert relerr(vp[1:], vj[1:]) <= agree
    assert type(rep["precond"]).__name__ == kind
    assert rep["plan"].nparts == nparts
    if kind == "SlabAMG":
        assert type(rep["precond"].A).__name__ == {
            "stencil": "SlabStencilOperator", "dia": "SlabDIAOperator"}[fine]
    else:
        assert rep["mixed"].converged and rep["plan"].L == 30
        sy = rep["system"]
        for v in (vp, vj):
            u = v[-1, 0, sy.free_to_node]
            r = sy.b - sy.A.matvec(u)
            assert np.linalg.norm(r) <= 1.5e-8 * np.linalg.norm(sy.b)
    assert "solve.partition" not in rep["timer"].as_dict()
