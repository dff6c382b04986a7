"""The drivers' ``--partitions`` routes: the port's ``cli/solve.py`` and
``cli/matrix_test.py`` against the JAX package's on the same unstructured
Exodus file (a refined tet box), both on the CPU (JAX on its 8 virtual
devices with ``--x64``, the port with ``--cpu``), in f64.

The "Converged in N iterations" lines are equal and the solution files'
values agree to 1e-10 relative (the same f64 solve summed in another
order); with snapshots both files hold the same timesteps.  The routes
include JAX's two quirks, which the port keeps: ``--precond ilut`` runs
Jacobi and ``--solver bicgstab`` runs CG.  The matrix test prints JAX's
final line, its numbers to 8 significant digits.
"""

import re

import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.cli.matrix_test import main as j_power
from domain_decomposed_pde_solver_tpu.cli.solve import main as j_main
from domain_decomposed_pde_solver_tpu_torch.cli.matrix_test import (
    main as p_power,
)
from domain_decomposed_pde_solver_tpu_torch.cli.solve import main as p_main
from domain_decomposed_pde_solver_tpu_torch.io import (
    box_mesh,
    read_nodal_vars,
    refine_uniform,
    write_exodus,
)
from torch_parity import relerr

torch.set_num_threads(1)

_CONVERGED = re.compile(r"^(Converged|DID NOT converge) in (\d+) iterations",
                        re.M)
_LAMBDA = re.compile(r"^lambda_max ~= (\S+) after (\d+) iterations "
                     r"\(residual (\S+), converged=(\w+)\)$", re.M)

ROUTES = {
    "cg-jacobi-snapshots": ["--precond", "jacobi", "--reportAfterIterations",
                            "9"],
    "cg-jacobi": ["--precond", "jacobi", "--no-snapshots"],
    "cg-chebyshev": ["--precond", "chebyshev", "--no-snapshots"],
    "cg-none": ["--precond", "none", "--no-snapshots"],
    "gmres-jacobi": ["--solver", "gmres", "--precond", "jacobi",
                     "--no-snapshots"],
    "gmres-amg": ["--solver", "gmres", "--precond", "amg", "--no-snapshots"],
    "cg-halo-amg": ["--precond", "amg", "--no-snapshots"],
    "cg-halo-amg-snapshots": ["--precond", "amg"],
    "ilut-is-jacobi": ["--solver", "gmres", "--precond", "ilut",
                       "--no-snapshots"],
    "bicgstab-is-cg": ["--solver", "bicgstab", "--precond", "jacobi",
                       "--no-snapshots"],
}


@pytest.fixture(scope="module")
def refined_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("parallel_cli") / "refined.exo"
    write_exodus(str(path), refine_uniform(box_mesh(5, 5, 4, "TETRA4"), 1))
    return path


def _run(main, exo, sol, args, extra, capsys):
    rc = main(["--input", str(exo), "--solution", str(sol), "--dtype",
               "float64", "--tolerance", "1e-10", "--iterations", "600"]
              + args + extra)
    text = capsys.readouterr().out
    m = _CONVERGED.search(text)
    assert m is not None, text
    return rc, m.group(0), read_nodal_vars(str(sol)), text


@pytest.mark.parametrize("nparts", [4])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_cli_partitions_matches_jax(refined_file, tmp_path, capsys, route,
                                    nparts):
    args = ["--partitions", str(nparts)] + ROUTES[route]
    report = {}
    rc_p, line_p, (_n, tp, vp), text_p = _run(
        lambda a: p_main(a, report=report), refined_file,
        tmp_path / "p.exo", args, ["--cpu"], capsys)
    rc_j, line_j, (_m, tj, vj), text_j = _run(
        j_main, refined_file, tmp_path / "j.exo", args, ["--cpu", "--x64"],
        capsys)
    assert rc_p == rc_j == 0
    assert line_p == line_j
    np.testing.assert_array_equal(tp, tj)
    assert vp.shape == vj.shape
    np.testing.assert_array_equal(vp[0], vj[0])  # the boundary snapshot
    assert relerr(vp[1:], vj[1:]) <= 1e-10
    assert report["plan"].nparts == nparts
    for note in ("warning: distributed AMG is CG-only", "note: per-chunk"):
        assert (note in text_p) == (note in text_j)
    kind = type(report["operator"]).__name__
    assert kind == "ShardedOperator"  # f64 on the CPU: JAX's ELL blocks
    assert "solve.partition" in report["timer"].as_dict()


def test_cli_partitions_f32_matches_jax(refined_file, tmp_path, capsys):
    """f32 Jacobi-CG over 4 parts: the port's ELL blocks on the CPU against
    JAX's (both iterate in f32: counts within 1, answers to f32 rounding
    amplified by the condition number)."""
    args = ["--partitions", "4", "--precond", "jacobi", "--no-snapshots",
            "--dtype", "float32", "--tolerance", "1e-5"]
    outs = {}
    for who, main, extra in (("p", p_main, ["--cpu"]),
                             ("j", j_main, ["--cpu"])):
        sol = tmp_path / f"{who}.exo"
        assert main(["--input", str(refined_file), "--solution", str(sol)]
                    + args + extra) == 0
        text = capsys.readouterr().out
        outs[who] = (int(_CONVERGED.search(text).group(2)),
                     read_nodal_vars(str(sol))[2][-1])
    assert abs(outs["p"][0] - outs["j"][0]) <= 1
    assert relerr(outs["p"][1], outs["j"][1]) <= 1e-3


@pytest.mark.parametrize("nparts", [2, 4, 8])
def test_matrix_test_partitions_matches_jax(tmp_path, capsys, nparts):
    path = tmp_path / "box.exo"
    write_exodus(str(path), refine_uniform(box_mesh(4, 4, 4, "TETRA4"), 1))
    extra = ["--partitions", str(nparts), "--iterations", "200",
             "--reportFrequency", "20", "--tolerance", "1e-6"]
    report = {}
    assert p_power(["--input", str(path), "--cpu"] + extra,
                   report=report) == 0
    ours = capsys.readouterr().out
    assert j_power(["--input", str(path), "--cpu"] + extra) == 0
    theirs = capsys.readouterr().out
    mo, mt = _LAMBDA.search(ours), _LAMBDA.search(theirs)
    assert mo is not None and mt is not None, (ours, theirs)
    assert mo.group(2, 4) == mt.group(2, 4)
    assert f"{float(mo.group(1)):.8g}" == f"{float(mt.group(1)):.8g}"
    assert report["plan"].nparts == nparts
    assert report["result"].iterations == int(mo.group(2))
