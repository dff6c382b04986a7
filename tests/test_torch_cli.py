"""The port's solve driver (``cli/solve.py``) against the JAX package's, on
a small structured box written to a temporary Exodus file, both on the CPU
(the port with ``--cpu``, JAX with ``--cpu --x64``).

Tolerances: the "Converged in N iterations" lines must be equal; solution
files are compared value by value, 1e-10 relative for the f64 Krylov
routes (the same f64 solve to 1e-10 in both, summation order amplified by
the condition number) and 1e-6 for the f64 refinement route (its inner
solves are f32, and the two packages round them differently).  Two routes
run a preconditioner that differs in rounding from JAX's by design: ILU
(JAX rounds its factors through f32) and Chebyshev (each package draws its
own power-method start vector); there the iteration counts may differ by
one and the answers, each solved to 1e-10, agree to 1e-8.  Host pieces
(the decomposed mesh, the debug dumps, the configuration) must be equal.
JAX's ``--x64`` and ``--debug-nans`` are accepted; the second raises on a
NaN in the answer or its residual.  The ``--checkpoint`` route is held to
JAX's in ``test_torch_checkpoint.py``.
"""

import re

import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.cli.solve import main as j_main
from domain_decomposed_pde_solver_tpu.io import box_mesh as j_box_mesh
from domain_decomposed_pde_solver_tpu.parallel.decompose import (
    decompose_mesh as j_decompose_mesh,
)
from domain_decomposed_pde_solver_tpu.utils import config as j_config
from domain_decomposed_pde_solver_tpu.utils.logging import (
    print_csr_matrix as j_print_csr,
    print_vector as j_print_vector,
)
from domain_decomposed_pde_solver_tpu_torch.cli.solve import main as p_main
from domain_decomposed_pde_solver_tpu_torch.io import (
    box_mesh,
    refine_uniform,
    write_exodus,
)
from domain_decomposed_pde_solver_tpu_torch.io import read_nodal_vars
from domain_decomposed_pde_solver_tpu_torch.models.heat import assemble_heat_system
from domain_decomposed_pde_solver_tpu_torch.parallel import decompose_mesh
from domain_decomposed_pde_solver_tpu_torch.utils import config as p_config
from domain_decomposed_pde_solver_tpu_torch.utils.logging import (
    print_csr_matrix,
    print_vector,
)
from torch_parity import relerr

torch.set_num_threads(1)

_CONVERGED = re.compile(r"^(Converged|DID NOT converge) in (\d+) iterations",
                        re.M)


@pytest.fixture
def box_file(tmp_path, monkeypatch):
    monkeypatch.setenv("DDPS_NO_COMPILE_CACHE", "1")
    path = tmp_path / "box.exo"
    write_exodus(str(path), box_mesh(10, 9, 8, elem_type="TETRA4"))
    return path


def _run_both(box_file, tmp_path, capsys, args):
    outs = {}
    for who, main, extra in (("port", p_main, ["--cpu"]),
                             ("jax", j_main, ["--cpu", "--x64"])):
        sol = tmp_path / f"{who}.exo"
        rc = main(["--input", str(box_file), "--solution", str(sol)]
                  + args + extra)
        text = capsys.readouterr().out
        m = _CONVERGED.search(text)
        assert m is not None, text
        outs[who] = (rc, m.group(0), read_nodal_vars(str(sol)), text)
    return outs["port"], outs["jax"]


def test_mixed_route_matches_jax(box_file, tmp_path, capsys):
    args = ["--dtype", "float64", "--precond", "amg", "--no-snapshots",
            "--tolerance", "1e-8"]
    report = {}
    rc = p_main(["--input", str(box_file), "--solution",
                 str(tmp_path / "r.exo"), "--cpu"] + args, report=report)
    assert rc == 0 and report["mixed"].converged
    assert type(report["operator"]).__name__ == "StencilOperator"
    capsys.readouterr()
    (rc_p, line_p, (_n, tp, vp), _), (rc_j, line_j, (_m, tj, vj), _) = \
        _run_both(box_file, tmp_path, capsys, args)
    assert rc_p == rc_j == 0
    assert line_p == line_j
    np.testing.assert_array_equal(tp, tj)
    assert vp.shape == vj.shape and vp.shape[0] == 2
    np.testing.assert_array_equal(vp[0], vj[0])  # the boundary snapshot
    assert relerr(vp[1], vj[1]) <= 1e-6


def test_cg_route_jacobi_with_snapshots_matches_jax(box_file, tmp_path,
                                                     capsys):
    args = ["--dtype", "float64", "--precond", "jacobi", "--tolerance",
            "1e-10"]
    (rc_p, line_p, (_n, tp, vp), _), (rc_j, line_j, (_m, tj, vj), _) = \
        _run_both(box_file, tmp_path, capsys, args)
    assert rc_p == rc_j == 0 and line_p == line_j
    iters = int(_CONVERGED.search(line_p).group(2))
    # One snapshot per iteration after the boundary timestep.
    assert len(tp) == len(tj) == iters + 1
    np.testing.assert_array_equal(tp, tj)
    assert relerr(vp[-1], vj[-1]) <= 1e-10


def test_cg_route_amg_matches_jax(box_file, tmp_path, capsys):
    args = ["--dtype", "float64", "--precond", "amg", "--tolerance", "1e-10",
            "--verbose"]
    (rc_p, line_p, (_n, tp, vp), text), (_rc, line_j, (_m, tj, vj), _t) = \
        _run_both(box_file, tmp_path, capsys, args)
    assert rc_p == 0 and line_p == line_j
    assert "operator format: DIAMatrix" in text
    assert "solve.iterate" in text  # the phase report
    assert relerr(vp[-1], vj[-1]) <= 1e-10


def test_decompose_blocks_match_jax():
    for nparts in (2, 3):
        pm = decompose_mesh(box_mesh(7, 6, 5, elem_type="TETRA4"), nparts)
        jm = j_decompose_mesh(j_box_mesh(7, 6, 5, elem_type="TETRA4"), nparts)
        assert len(pm.blocks) == len(jm.blocks) == nparts
        for bp, bj in zip(pm.blocks, jm.blocks):
            assert (bp.id, bp.elem_type, bp.name) == (bj.id, bj.elem_type,
                                                       bj.name)
            np.testing.assert_array_equal(bp.conn, bj.conn)
        np.testing.assert_array_equal(pm.elem_id_map, jm.elem_id_map)


def test_debug_dumps_match_jax(tmp_path):
    sy = assemble_heat_system(box_mesh(5, 4, 4, elem_type="TETRA4"))
    x = np.random.default_rng(0).normal(size=sy.n_free)
    for who, pcsr, pvec in (("port", print_csr_matrix, print_vector),
                            ("jax", j_print_csr, j_print_vector)):
        prefix = str(tmp_path / f"{who}_")
        pcsr(sy.A, "Laplacian: A", prefix)
        pvec(x, "Solution: X", prefix)
    assert ((tmp_path / "port_0.out").read_text()
            == (tmp_path / "jax_0.out").read_text())


def test_config_matches_jax():
    import argparse

    assert p_config.SolveConfig() == p_config.SolveConfig(
        **vars(j_config.SolveConfig()))
    argv = ["--input", "m.exo", "--tolerance", "1e-7", "--precond", "amg",
            "--no-snapshots", "--reportAfterIterations", "3"]
    aps = []
    for mod in (p_config, j_config):
        ap = argparse.ArgumentParser()
        mod.add_solve_args(ap)
        aps.append(vars(mod.config_from_args(ap.parse_args(argv))))
    assert aps[0] == aps[1]


@pytest.mark.parametrize("route", [
    ["--precond", "jacobi"],
    ["--precond", "amg", "--no-snapshots"],
], ids=["cg-jacobi", "refinement"])
def test_jax_flags_are_accepted(box_file, tmp_path, capsys, route):
    """JAX's ``--x64`` and ``--debug-nans`` on a converging solve: the same
    run, line for line, as without them."""
    base = ["--input", str(box_file), "--cpu", "--dtype", "float64",
            "--tolerance", "1e-8"] + route
    texts = []
    for extra in ([], ["--x64", "--debug-nans"]):
        rc = p_main(base + ["--solution", str(tmp_path / "s.exo")] + extra)
        assert rc == 0
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1]


@pytest.mark.parametrize("what", ["answer", "residual"])
def test_debug_nans_raises_on_a_nan(box_file, tmp_path, monkeypatch, what):
    """``--debug-nans`` checks the solve's answer and the residual it
    reports: a NaN in either raises ``FloatingPointError``; without the
    flag the run ends, unconverged."""
    import dataclasses

    from domain_decomposed_pde_solver_tpu_torch.solvers import cg as p_cg

    real = p_cg.cg_solve_snapshots

    def poisoned(*args, **kwargs):
        res = real(*args, **kwargs)
        if what == "answer":
            x = res.x.clone()
            x[3] = float("nan")
            return dataclasses.replace(res, x=x)
        return dataclasses.replace(res, relres=float("nan"), converged=False)

    monkeypatch.setattr(p_cg, "cg_solve_snapshots", poisoned)
    args = ["--input", str(box_file), "--solution", str(tmp_path / "s.exo"),
            "--cpu", "--dtype", "float64", "--precond", "jacobi",
            "--tolerance", "1e-8"]
    with pytest.raises(FloatingPointError, match="debug-nans"):
        p_main(args + ["--debug-nans"])
    assert p_main(args) in (0, 1)


def test_missing_input_returns_1(tmp_path, capsys):
    rc = p_main(["--input", str(tmp_path / "nope.exo"), "--cpu"])
    assert rc == 1 and "error" in capsys.readouterr().err


def test_the_card_is_the_default(box_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_main(["--input", str(box_file), "--solution",
                str(tmp_path / "s.exo")])


@pytest.mark.parametrize(
    "args",
    [
        ["--dtype", "float64", "--precond", "amg", "--no-snapshots",
         "--tolerance", "1e-8"],
        ["--dtype", "float32", "--precond", "amg", "--tolerance", "1e-6"],
        ["--dtype", "float64", "--precond", "none", "--tolerance", "1e-8"],
    ],
    ids=["f64-refinement", "f32-amg", "f64-none"],
)
def test_unstructured_routes_match_jax(tmp_path, capsys, monkeypatch, args):
    """A refined (unstructured) box: the port's sliced-ELL operators
    against JAX's ELL/Split-ELL on the CPU, the same iteration counts
    (the achieved tolerances differ by summation order)."""
    monkeypatch.setenv("DDPS_NO_COMPILE_CACHE", "1")
    path = tmp_path / "refined.exo"
    write_exodus(str(path), refine_uniform(box_mesh(7, 6, 5,
                                                    elem_type="TETRA4"), 1))
    (rc_p, line_p, _vp, _), (rc_j, line_j, _vj, _) = _run_both(
        path, tmp_path, capsys, args)
    assert rc_p == rc_j == 0
    assert (_CONVERGED.search(line_p).group(2)
            == _CONVERGED.search(line_j).group(2))


# Krylov routes of the CLI: (arguments, iteration slack, value tolerance).
KRYLOV_ROUTES = {
    "gmres-jacobi": (["--solver", "gmres", "--precond", "jacobi",
                      "--restart", "20"], 0, 1e-10),
    "gmres-ilu0": (["--solver", "gmres", "--precond", "ilu0",
                    "--no-snapshots"], 1, 1e-8),
    "gmres-ilut": (["--solver", "gmres", "--precond", "ilut"], 1, 1e-8),
    "bicgstab-jacobi": (["--solver", "bicgstab", "--precond", "jacobi"], 0,
                        1e-10),
    "cg-chebyshev": (["--precond", "chebyshev"], 1, 1e-8),
}


def _host_relres(path, box_path):
    from domain_decomposed_pde_solver_tpu_torch.io import read_exodus

    sy = assemble_heat_system(read_exodus(str(box_path)))
    u = read_nodal_vars(str(path))[2][-1, 0, sy.free_to_node]
    return float(np.linalg.norm(sy.A.matvec(u) - sy.b) / np.linalg.norm(sy.b))


@pytest.mark.parametrize("route", sorted(KRYLOV_ROUTES))
def test_krylov_routes_match_jax(box_file, tmp_path, capsys, route):
    """GMRES (snapshots per restart cycle, or none), BiCGStab and the
    preconditioners the reference's factory offers, on the structured box
    (f64, to 1e-10): the port's answer file against JAX's."""
    extra, slack, vtol = KRYLOV_ROUTES[route]
    args = ["--dtype", "float64", "--tolerance", "1e-10"] + extra
    (rc_p, line_p, (_n, tp, vp), _), (rc_j, line_j, (_m, tj, vj), _t) = \
        _run_both(box_file, tmp_path, capsys, args)
    assert rc_p == rc_j == 0
    it_p = int(_CONVERGED.search(line_p).group(2))
    it_j = int(_CONVERGED.search(line_j).group(2))
    assert abs(it_p - it_j) <= slack
    if slack == 0:
        assert line_p == line_j
        np.testing.assert_array_equal(tp, tj)
    np.testing.assert_array_equal(vp[0], vj[0])  # the boundary snapshot
    assert relerr(vp[-1], vj[-1]) <= vtol
    assert _host_relres(tmp_path / "port.exo", box_file) <= 2e-10


def test_gmres_snapshot_every_iteration_matches_jax(box_file, tmp_path,
                                                    capsys):
    """The reference's literal loop: one Arnoldi step per solve call, X
    written, Krylov space reset; 6 steps do not converge."""
    args = ["--dtype", "float64", "--solver", "gmres", "--precond", "jacobi",
            "--snapshot-every-iteration", "--iterations", "6",
            "--tolerance", "1e-12"]
    (rc_p, line_p, (_n, tp, vp), _), (rc_j, line_j, (_m, tj, vj), _t) = \
        _run_both(box_file, tmp_path, capsys, args)
    assert rc_p == rc_j == 1
    assert line_p.startswith("DID NOT converge in 6 iterations")
    assert line_p == line_j
    assert len(tp) == len(tj) == 7
    np.testing.assert_array_equal(tp, tj)
    assert relerr(vp[1:], vj[1:]) <= 1e-10


@pytest.mark.parametrize(
    "extra",
    [["--solver", "gmres", "--precond", "ilut", "--no-snapshots"],
     ["--solver", "bicgstab", "--precond", "jacobi"],
     ["--solver", "cg", "--precond", "chebyshev", "--no-snapshots"]],
    ids=["gmres-ilut", "bicgstab-jacobi", "cg-chebyshev"],
)
def test_krylov_routes_on_an_unstructured_mesh(tmp_path, capsys,
                                               monkeypatch, extra):
    """The three reference routes of the smoke's path D3 on a refined box
    with ``--cpu``: they converge, the file's answer has a host f64
    residual within the tolerance and keeps the maximum principle, and
    the iteration counts are JAX's (one apart at most: the preconditioner
    of two of them differs in rounding by design)."""
    monkeypatch.setenv("DDPS_NO_COMPILE_CACHE", "1")
    path = tmp_path / "refined.exo"
    write_exodus(str(path), refine_uniform(box_mesh(7, 6, 5,
                                                    elem_type="TETRA4"), 1))
    args = ["--dtype", "float64", "--tolerance", "1e-8"] + extra
    rep = {}
    rc = p_main(["--input", str(path), "--solution", str(tmp_path / "u.exo"),
                 "--cpu"] + args, report=rep)
    assert rc == 0 and rep["result"].converged
    gate = "ilu" not in " ".join(extra)
    assert (type(rep["operator"]).__name__ == "BSGMatrix"
            and (rep["operator"].perm is not None) == gate)
    rr = _host_relres(tmp_path / "u.exo", path)
    assert rr <= 1.5e-8
    vals = read_nodal_vars(str(tmp_path / "u.exo"))[2][-1, 0]
    assert 100.0 <= vals.min() and vals.max() <= 1000.0
    capsys.readouterr()
    (rc_p, line_p, _vp, _), (rc_j, line_j, _vj, _) = _run_both(
        path, tmp_path, capsys, args)
    assert rc_p == rc_j == 0
    assert abs(int(_CONVERGED.search(line_p).group(2))
               - int(_CONVERGED.search(line_j).group(2))) <= 1
