"""The port's solve driver (``cli/solve.py``) against the JAX package's, on
a small structured box written to a temporary Exodus file, both on the CPU
(the port with ``--cpu``, JAX with ``--cpu --x64``).

Tolerances: the "Converged in N iterations" lines must be equal; solution
files are compared value by value, 1e-10 relative for the f64 CG route
(the same f64 solve to 1e-10 in both, summation order amplified by the
condition number) and 1e-6 for the f64 refinement route (its inner solves
are f32, and the two packages round them differently).  Host pieces (the
decomposed mesh, the debug dumps, the configuration) must be equal.
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


@pytest.mark.parametrize(
    "extra,match",
    [
        (["--partitions", "2"], "item 9"),
        (["--solver", "gmres"], "item 8"),
        (["--solver", "bicgstab"], "item 8"),
        (["--precond", "ilu0"], "item 8"),
        (["--precond", "ilut"], "item 8"),
        (["--precond", "chebyshev"], "item 8"),
        (["--checkpoint", "ck.npz"], "item 8"),
    ],
)
def test_routes_not_ported_raise(box_file, tmp_path, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        p_main(["--input", str(box_file), "--solution",
                str(tmp_path / "s.exo"), "--cpu"] + extra)


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
