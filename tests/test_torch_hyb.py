"""The port's HYB format (``ops/hyb.py``: popular diagonals as DIA, the
rest as ELL) against the JAX package's.

Both packages get the same assembled arrays: refined tet boxes
(``tests/torch_parity.py``) after the same RCM reordering, whose
popular diagonals number 213 at 5^3 (more than 128), 157 at 6^3 and
117 at 8^3, and a structured box
whose every entry lies on a diagonal (an empty ELL part).  Random vectors
come from numpy with fixed seeds.

Tolerances: the split (offsets, DIA data, ELL columns and values) and the
byte count are equal; the diagonal is equal.  A product adds the same
products in another order (JAX's pairwise DIA tree and XLA's row sums
against the port's), so it agrees to 1e-12 relative in f64, 1e-6 in f32.
Jacobi-PCG takes JAX's iterations in f64 and within one in f32, where
rounding can move the stopping iteration.  On the card the DIA part runs
kernel 4 (``tests/test_torch_cuda.py``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.io import box_mesh as j_box_mesh
from domain_decomposed_pde_solver_tpu.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu.ops import dia as j_dia
from domain_decomposed_pde_solver_tpu.ops import hyb as j_hyb
from domain_decomposed_pde_solver_tpu.solvers import cg_solve as j_cg_solve
from domain_decomposed_pde_solver_tpu.solvers.precond.jacobi import (
    DiagonalPreconditioner as JDiag,
)
from domain_decomposed_pde_solver_tpu_torch import ops as p_ops
from domain_decomposed_pde_solver_tpu_torch.ops import dia as p_dia
from domain_decomposed_pde_solver_tpu_torch.ops import hyb as p_hyb
from domain_decomposed_pde_solver_tpu_torch.ops.reorder import rcm_permute
from domain_decomposed_pde_solver_tpu_torch.solvers import cg_solve
from domain_decomposed_pde_solver_tpu_torch.solvers.precond.jacobi import (
    DiagonalPreconditioner,
)
from torch_parity import jax_problem, port_csr, rand, relerr

torch.set_num_threads(1)

TOL = {"float32": 1e-6, "float64": 1e-12}
MESHES = ["tet5r", "tet6r", "tet8r", "box9"]


@functools.lru_cache(maxsize=None)
def _system(name):
    """(JAX system, JAX CSR, port CSR, perm): RCM-permuted, the structured
    box in its own lexicographic numbering."""
    if name == "box9":
        sy = assemble_heat_system(j_box_mesh(9, 8, 7, elem_type="TETRA4"))
        return sy, sy.A, port_csr(sy), np.arange(sy.A.n_rows)
    d = int(name[3])
    _mesh, sy = jax_problem((d, d, d))
    Aj, perm = j_hyb.rcm_permute(sy.A)
    csr, perm_p = rcm_permute(port_csr(sy))
    np.testing.assert_array_equal(perm_p, perm)
    return sy, Aj, csr, perm


def _pair(name, dtype_name, **kw):
    _sy, Aj, csr, _perm = _system(name)
    Hj = j_hyb.hyb_from_csr(Aj, dtype=getattr(jnp, dtype_name), **kw)
    Hp = p_hyb.hyb_from_csr(csr, dtype=getattr(torch, dtype_name),
                            device="cpu", **kw)
    return Hj, Hp


def test_exports_and_rcm_permute():
    assert p_ops.HYBMatrix is p_hyb.HYBMatrix
    assert p_ops.hyb_from_csr is p_hyb.hyb_from_csr
    assert p_hyb.rcm_permute is rcm_permute
    sy, Aj, csr, perm = _system("tet6r")
    np.testing.assert_array_equal(csr.indptr, Aj.indptr)
    np.testing.assert_array_equal(csr.indices, Aj.indices)
    np.testing.assert_array_equal(csr.data, Aj.data)


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("kw", [{}, {"min_occupancy": 0.1},
                                {"max_diags": 8}],
                         ids=["default", "occ0.1", "cap8"])
@pytest.mark.parametrize("name", MESHES)
def test_split_matches_jax(name, kw, dtype_name):
    Hj, Hp = _pair(name, dtype_name, **kw)
    assert Hp.dia.offsets == Hj.dia.offsets
    assert list(Hp.dia.offsets) == sorted(Hp.dia.offsets)
    assert (Hp.n_pad, Hp.n_rows, Hp.n_cols) == (Hj.n_pad, Hj.n_rows,
                                                 Hj.n_cols)
    assert Hp.dtype == getattr(torch, str(Hj.dtype))
    # The DIA part stores in dtype: JAX applies no bfloat16 rule here.
    assert Hp.dia.data.dtype == Hp.dtype and not Hp.dia.compute_dtype
    np.testing.assert_array_equal(Hp.dia.data.numpy(), np.asarray(Hj.dia.data))
    np.testing.assert_array_equal(Hp.ell.cols.numpy(), np.asarray(Hj.ell.cols))
    np.testing.assert_array_equal(Hp.ell.vals.numpy(), np.asarray(Hj.ell.vals))
    assert Hp.ell.n_pad == Hp.n_pad
    assert p_dia.operator_bytes(Hp) == j_dia.operator_bytes(Hj)
    np.testing.assert_array_equal(Hp.diagonal_padded(fill=2.0).numpy(),
                                  np.asarray(Hj.diagonal_padded(fill=2.0)))
    # The split is complete.
    _sy, Aj, _csr, _perm = _system(name)
    nnz = int((Hp.dia.data != 0).sum() + (Hp.ell.vals != 0).sum())
    assert nnz == Aj.nnz


def test_diagonal_counts_of_the_fixtures():
    """The fixtures reach the counts the module docstring names: more
    than 128 popular diagonals at 5^3, an empty ELL part on the box."""
    counts = {n: _pair(n, "float64")[1].dia.ndiags for n in MESHES}
    assert counts["tet5r"] > 128 and counts["tet8r"] < 128
    assert not _pair("box9", "float64")[1].ell.vals.any()


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("name", MESHES)
def test_matvec_matches_jax(name, dtype_name):
    Hj, Hp = _pair(name, dtype_name)
    x = rand(Hp.n_pad, seed=5).astype(dtype_name)
    x[Hp.n_rows:] = 0
    yj = np.asarray(Hj.matvec(jnp.asarray(x)))
    yp = Hp.matvec(torch.from_numpy(x)).numpy()
    assert yp.dtype == yj.dtype
    assert relerr(yp, yj) <= TOL[dtype_name]
    _sy, Aj, _csr, _perm = _system(name)
    assert relerr(yp[:Hp.n_rows], Aj.matvec(x[:Hp.n_rows].astype(
        np.float64))) <= TOL[dtype_name]


def test_astype_matches_jax():
    Hj, Hp = _pair("tet6r", "float64")
    Aj, Ap = Hj.astype(jnp.float32), Hp.astype(torch.float32)
    assert Ap.dtype == torch.float32 and Ap.ell.cols.dtype == torch.int64
    np.testing.assert_array_equal(Ap.dia.data.numpy(), np.asarray(Aj.dia.data))
    np.testing.assert_array_equal(Ap.ell.vals.numpy(), np.asarray(Aj.ell.vals))
    assert Ap.astype("float64").dtype == torch.float64


@pytest.mark.parametrize("dtype_name,slack",
                         [("float64", 0), ("float32", 1)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("name", ["tet5r", "tet8r"])
def test_jacobi_cg_matches_jax(name, dtype_name, slack):
    """Permute, solve on HYB, un-permute: JAX's iterations and answer."""
    sy, _Aj, _csr, perm = _system(name)
    Hj, Hp = _pair(name, dtype_name)
    tol = 1e-10 if dtype_name == "float64" else 1e-5
    b = sy.b[perm].astype(dtype_name)
    bj = Hj.put_vector(b)
    rj = j_cg_solve(Hj, bj, jnp.zeros_like(bj),
                    precond=JDiag(1.0 / Hj.diagonal_padded()), tol=tol,
                    maxiter=2000)
    bp = Hp.put_vector(b)
    rp = cg_solve(Hp, bp, torch.zeros_like(bp),
                  precond=DiagonalPreconditioner(1.0 / Hp.diagonal_padded()),
                  tol=tol, maxiter=2000)
    assert rp.converged and bool(rj.converged)
    assert abs(rp.iterations - int(rj.iterations)) <= slack
    x = np.zeros(sy.A.n_rows)
    x[perm] = Hp.get_vector(rp.x)
    host = np.linalg.norm(sy.b - sy.A.matvec(x)) / np.linalg.norm(sy.b)
    assert host <= (1e-9 if dtype_name == "float64" else 1e-4)
    if dtype_name == "float64":
        assert relerr(Hp.get_vector(rp.x), Hj.get_vector(rj.x)) <= 1e-10
