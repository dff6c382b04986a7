"""Resumable CG and its checkpoint files: the port against the JAX package.

- A checkpoint either package writes loads in the other, value for value.
- An unbroken resumable solve takes JAX's iteration count, and its answer
  agrees with JAX's within 1e-10 relative (the same f64 recurrence summed
  in another order).
- A solve stopped and resumed is bit-identical to the unbroken solve (the
  property of JAX's ``tests/test_refine_checkpoint.py:96``, on a generated
  box in place of the reference's meshes).
- A checkpoint of another problem (another ``b``, another operator, or
  JAX's, whose operator hash covers its own arrays) raises ``ValueError``.
- The CLI's ``--checkpoint`` route stops, resumes and converges.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.io import box_mesh as j_box_mesh
from domain_decomposed_pde_solver_tpu.models import (
    assemble_heat_system as j_assemble,
)
from domain_decomposed_pde_solver_tpu.ops import (
    choose_operator as j_choose_operator,
    pad_vector as j_pad_vector,
)
from domain_decomposed_pde_solver_tpu.solvers import (
    cg_solve_resumable as j_cg_solve_resumable,
    jacobi_preconditioner as j_jacobi,
)
from domain_decomposed_pde_solver_tpu.utils import checkpoint as j_ck
from domain_decomposed_pde_solver_tpu_torch.ops.dia import choose_operator
from domain_decomposed_pde_solver_tpu_torch.solvers import (
    cg_solve_resumable,
    jacobi_preconditioner,
)
from domain_decomposed_pde_solver_tpu_torch.utils import checkpoint as p_ck
from torch_parity import port_csr, relerr

torch.set_num_threads(1)

TOL = 1e-12


@functools.lru_cache(maxsize=None)
def _system():
    return j_assemble(j_box_mesh(10, 9, 8, elem_type="TETRA4"))


def _port_problem(system=None):
    sy = _system() if system is None else system
    A = choose_operator(port_csr(sy), dtype=torch.float64, device="cpu")
    b = A.put_vector(sy.b)
    return A, b, torch.zeros_like(b), jacobi_preconditioner(A)


def _port_solve(path, maxiter=2000, every=10, problem=None):
    A, b, x0, M = problem or _port_problem()
    return cg_solve_resumable(A, b, x0, checkpoint_path=str(path),
                              checkpoint_every=every, precond=M, tol=TOL,
                              maxiter=maxiter)


def _jax_solve(path, maxiter=2000, every=10):
    sy = _system()
    A = j_choose_operator(sy.A, dtype=jnp.float64)
    b = j_pad_vector(sy.b, A.n_pad)
    return A, j_cg_solve_resumable(A, b, jnp.zeros_like(b),
                                   checkpoint_path=str(path),
                                   checkpoint_every=every,
                                   precond=j_jacobi(A), tol=TOL,
                                   maxiter=maxiter)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_files_load_across_packages(tmp_path, writer):
    rng = np.random.default_rng(3)
    fields = dict(x=rng.normal(size=7), r=rng.normal(size=7),
                  p=rng.normal(size=7).astype(np.float32), rz=3.25,
                  iteration=17, meta={"tol": 1e-10, "b_hash": "ab"})
    save, load = ((p_ck, j_ck) if writer == "port" else (j_ck, p_ck))
    path = str(tmp_path / "state.npz")
    save.save_checkpoint(path, save.CGCheckpoint(**fields))
    back = load.load_checkpoint(path)
    for key in ("x", "r", "p"):
        np.testing.assert_array_equal(getattr(back, key), fields[key])
        assert getattr(back, key).dtype == fields[key].dtype
    assert (back.rz, back.iteration, back.meta) == (3.25, 17, fields["meta"])
    assert load.load_checkpoint(str(tmp_path / "missing.npz")) is None


def test_unbroken_solve_matches_jax(tmp_path):
    res = _port_solve(tmp_path / "port.npz")
    A, jres = _jax_solve(tmp_path / "jax.npz")
    assert res.converged and bool(jres.converged)
    assert res.iterations == int(jres.iterations)
    n = _system().n_free
    assert relerr(res.x[:n].numpy(), np.asarray(jres.x)[:n]) <= 1e-10
    # Both wrote their last checkpoint at the same iteration.
    k = res.iterations // 10 * 10
    assert (p_ck.load_checkpoint(str(tmp_path / "port.npz")).iteration
            == j_ck.load_checkpoint(str(tmp_path / "jax.npz")).iteration
            == k)


def test_resumed_solve_is_bit_identical(tmp_path):
    whole = _port_solve(tmp_path / "whole.npz")
    path = tmp_path / "broken.npz"
    first = _port_solve(path, maxiter=40)
    assert not first.converged and first.iterations == 40
    assert p_ck.load_checkpoint(str(path)).iteration == 40
    rest = _port_solve(path)
    assert rest.converged
    assert rest.iterations == whole.iterations
    assert torch.equal(rest.x, whole.x)
    assert rest.relres == whole.relres


def test_jax_refuses_a_port_checkpoint(tmp_path):
    """The other way round: the JAX package refuses the port's file."""
    path = tmp_path / "state.npz"
    _port_solve(path, maxiter=20)
    with pytest.raises(ValueError, match="operator hash"):
        _jax_solve(path)


@pytest.mark.parametrize("change", ["rhs", "operator", "jax-file"])
def test_checkpoint_of_another_problem_raises(tmp_path, change):
    path = tmp_path / "state.npz"
    A, b, x0, M = _port_problem()
    if change == "jax-file":
        _jax_solve(path, maxiter=20)
        jax_meta = p_ck.load_checkpoint(str(path)).meta
        _port_solve(tmp_path / "own.npz", maxiter=20)
        own = p_ck.load_checkpoint(str(tmp_path / "own.npz")).meta
        # The same b in the same layout hashes as JAX's; the operator not.
        assert own["b_hash"] == jax_meta["b_hash"]
        assert own["a_hash"] != jax_meta["a_hash"]
        match = "operator hash"
    else:
        _port_solve(path, maxiter=20)
        if change == "rhs":
            b = 2.0 * b
        else:
            # The same b against another matrix: the diagonal shifted by 1.
            A = choose_operator(port_csr(_system()), dtype=torch.float64,
                                device="cpu")
            A.data[A.offsets.index(0)] += 1
        match = "different problem"
    with pytest.raises(ValueError, match=match):
        cg_solve_resumable(A, b, x0, checkpoint_path=str(path),
                           checkpoint_every=10, precond=M, tol=TOL,
                           maxiter=2000)


def test_cli_checkpoint_route_stops_and_resumes(tmp_path, capsys,
                                               monkeypatch):
    """``--checkpoint`` takes the resumable CG even where the f64 AMG
    route would refine (JAX's branch order); capped at 4 iterations it
    stops, and run again it continues to JAX's iteration count."""
    from domain_decomposed_pde_solver_tpu.cli.solve import main as j_main
    from domain_decomposed_pde_solver_tpu_torch.cli.solve import main
    from domain_decomposed_pde_solver_tpu_torch.io import (
        box_mesh,
        read_nodal_vars,
        write_exodus,
    )

    monkeypatch.setenv("DDPS_NO_COMPILE_CACHE", "1")
    mesh = tmp_path / "box.exo"
    write_exodus(str(mesh), box_mesh(10, 9, 8, elem_type="TETRA4"))
    ck = str(tmp_path / "ck.npz")
    args = ["--input", str(mesh), "--dtype", "float64", "--precond", "amg",
            "--no-snapshots", "--tolerance", "1e-12", "--checkpoint", ck,
            "--checkpoint-every", "2"]
    rep = {}
    rc = main(args + ["--solution", str(tmp_path / "a.exo"), "--cpu",
                      "--iterations", "4"], report=rep)
    assert rc == 1 and "mixed" not in rep and rep["result"].iterations == 4
    assert p_ck.load_checkpoint(ck).iteration == 4
    rc = main(args + ["--solution", str(tmp_path / "b.exo"), "--cpu"],
              report=rep)
    out = capsys.readouterr().out
    assert rc == 0 and rep["result"].converged
    line = [ln for ln in out.splitlines() if ln.startswith("Converged")][0]
    rc_j = j_main(["--input", str(mesh), "--dtype", "float64", "--precond",
                   "amg", "--no-snapshots", "--tolerance", "1e-12",
                   "--checkpoint", str(tmp_path / "j.npz"),
                   "--checkpoint-every", "2", "--solution",
                   str(tmp_path / "j.exo"), "--cpu", "--x64"])
    j_out = capsys.readouterr().out
    assert rc_j == 0
    j_line = [ln for ln in j_out.splitlines() if ln.startswith("Converged")]
    assert line.split("(")[0] == j_line[0].split("(")[0]
    sy = rep["system"]
    u = read_nodal_vars(str(tmp_path / "b.exo"))[2][-1, 0, sy.free_to_node]
    rr = np.linalg.norm(sy.A.matvec(u) - sy.b) / np.linalg.norm(sy.b)
    assert rr <= 2e-12
