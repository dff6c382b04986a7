"""The port's Split-ELL format (``ops/splitell.py``: an ELL capped at the
cost-minimising width ``K*`` plus a flat overflow tail) against the JAX
package's.

Both packages get the same assembled arrays: refined tet boxes
(``tests/torch_parity.py``), a structured box, and a periodic 3-D
Laplacian whose rows all hold seven entries (no tail: the tail is eight
zero entries, as in JAX).  Random vectors come from numpy with fixed
seeds.

Tolerances: the cap, the capped arrays, the tail arrays and the byte
count are equal; the diagonal is equal.  JAX adds the tail with a
scatter-add, the port each row's tail in slot order and then once to the
row (the same bits on every run, on the card too); a product therefore
agrees to 1e-12 relative in f64, 1e-6 in f32, with JAX's and with the
port's scatter-add form (``splitell_matvec_plain``).  Jacobi-PCG takes
JAX's iterations in f64 and within one in f32.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from domain_decomposed_pde_solver_tpu.io import box_mesh as j_box_mesh
from domain_decomposed_pde_solver_tpu.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu.ops import dia as j_dia
from domain_decomposed_pde_solver_tpu.ops import splitell as j_spl
from domain_decomposed_pde_solver_tpu.ops.csr import CSRMatrix as JCSR
from domain_decomposed_pde_solver_tpu.solvers import cg_solve as j_cg_solve
from domain_decomposed_pde_solver_tpu.solvers.precond.jacobi import (
    DiagonalPreconditioner as JDiag,
)
from domain_decomposed_pde_solver_tpu_torch import ops as p_ops
from domain_decomposed_pde_solver_tpu_torch.ops import dia as p_dia
from domain_decomposed_pde_solver_tpu_torch.ops import splitell as p_spl
from domain_decomposed_pde_solver_tpu_torch.solvers import cg_solve
from domain_decomposed_pde_solver_tpu_torch.solvers.precond.jacobi import (
    DiagonalPreconditioner,
)
from domain_decomposed_pde_solver_tpu_torch.utils.convert import csr_from_numpy
from torch_parity import jax_problem, port_csr, rand, relerr

torch.set_num_threads(1)

TOL = {"float32": 1e-6, "float64": 1e-12}
MATRICES = ["tet5r", "tet8r", "box9", "periodic"]


def _periodic(m=9):
    """The 7-point Laplacian of an m^3 torus plus the identity: seven
    entries in every row, symmetric positive definite."""
    n = m ** 3
    i = np.arange(n)
    x, y, z = i % m, (i // m) % m, i // (m * m)
    rows, cols = [i], [i]
    for dx, dy, dz in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                       (0, 0, 1), (0, 0, -1)):
        rows.append(i)
        cols.append((x + dx) % m + m * ((y + dy) % m) + m * m * ((z + dz) % m))
    vals = np.concatenate([np.full(n, 7.0)] + [np.full(n, -1.0)] * 6)
    S = sp.csr_matrix((vals, (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    S.sort_indices()
    return S


@functools.lru_cache(maxsize=None)
def _matrices(name):
    """(JAX CSR, port CSR, right-hand side)."""
    if name == "periodic":
        S = _periodic()
        Aj = JCSR(indptr=S.indptr.astype(np.int64),
                  indices=S.indices.astype(np.int64), data=S.data,
                  shape=S.shape)
        b = np.random.default_rng(4).uniform(0, 1, S.shape[0])
        return Aj, csr_from_numpy(S.indptr, S.indices, S.data, S.shape), b
    if name == "box9":
        sy = assemble_heat_system(j_box_mesh(9, 8, 7, elem_type="TETRA4"))
    else:
        d = int(name[3])
        _mesh, sy = jax_problem((d, d, d))
    return sy.A, port_csr(sy), sy.b


def _pair(name, dtype_name):
    Aj, csr, _b = _matrices(name)
    Sj = j_spl.splitell_from_csr(Aj, dtype=getattr(jnp, dtype_name))
    Sp = p_spl.splitell_from_csr(csr, dtype=getattr(torch, dtype_name),
                                 device="cpu")
    return Sj, Sp


def test_exports():
    assert p_ops.SplitELLMatrix is p_spl.SplitELLMatrix
    assert p_ops.splitell_from_csr is p_spl.splitell_from_csr


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("name", MATRICES)
def test_arrays_match_jax(name, dtype_name):
    Sj, Sp = _pair(name, dtype_name)
    assert Sp.row_width == Sj.row_width  # K*
    assert (Sp.n_pad, Sp.n_rows, Sp.n_cols) == (Sj.n_pad, Sj.n_rows,
                                                 Sj.n_cols)
    assert Sp.dtype == getattr(torch, str(Sj.dtype))
    for f in ("cols", "vals", "tail_rows", "tail_cols", "tail_vals"):
        np.testing.assert_array_equal(getattr(Sp, f).numpy(),
                                      np.asarray(getattr(Sj, f)), f)
    assert p_dia.operator_bytes(Sp) == j_dia.operator_bytes(Sj)
    np.testing.assert_array_equal(Sp.diagonal_padded(fill=3.0).numpy(),
                                  np.asarray(Sj.diagonal_padded(fill=3.0)))


def test_uniform_rows_have_no_tail():
    _Sj, Sp = _pair("periodic", "float64")
    assert Sp.row_width == 7
    assert Sp.tail_rows.numel() == 8 and not Sp.tail_vals.any()


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("name", MATRICES)
def test_matvec_matches_jax(name, dtype_name):
    Sj, Sp = _pair(name, dtype_name)
    x = rand(Sp.n_pad, seed=6).astype(dtype_name)
    x[Sp.n_rows:] = 0
    yj = np.asarray(Sj.matvec(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    yp = Sp.matvec(xt)
    assert yp.dtype == getattr(torch, dtype_name)
    assert relerr(yp.numpy(), yj) <= TOL[dtype_name]
    assert relerr(yp.numpy(), p_spl.splitell_matvec_plain(Sp, xt).numpy()
                  ) <= TOL[dtype_name]
    assert torch.equal(Sp.matvec(xt), yp)
    Aj, _csr, _b = _matrices(name)
    assert relerr(yp.numpy()[:Sp.n_rows], Aj.matvec(
        x[:Sp.n_rows].astype(np.float64))) <= TOL[dtype_name]


def test_tail_in_any_order():
    """The fixed-order tail takes the tail's rows in any order (here
    shuffled, padding entries among them) and sums each row in tail
    order."""
    _Sj, Sp = _pair("tet5r", "float64")
    order = torch.from_numpy(np.random.default_rng(8).permutation(
        Sp.tail_rows.numel()))
    Sq = p_spl.SplitELLMatrix(Sp.cols, Sp.vals, Sp.tail_rows[order],
                              Sp.tail_cols[order], Sp.tail_vals[order],
                              Sp.n_rows, Sp.n_cols)
    x = torch.from_numpy(rand(Sp.n_pad, seed=9))
    assert relerr(Sq.matvec(x).numpy(), Sp.matvec(x).numpy()) <= 1e-14
    rows, cols, vals = Sq._tail
    assert torch.equal(rows, torch.unique(Sp.tail_rows))
    assert vals.shape == cols.shape == (rows.numel(), vals.shape[1])


def test_astype_matches_jax():
    Sj, Sp = _pair("tet8r", "float64")
    Aj, Ap = Sj.astype(jnp.float32), Sp.astype(torch.float32)
    assert Ap.dtype == torch.float32 and Ap.cols is Sp.cols
    np.testing.assert_array_equal(Ap.vals.numpy(), np.asarray(Aj.vals))
    np.testing.assert_array_equal(Ap.tail_vals.numpy(),
                                  np.asarray(Aj.tail_vals))
    x = torch.from_numpy(rand(Sp.n_pad, seed=2).astype(np.float32))
    yj = np.asarray(Aj.matvec(jnp.asarray(x.numpy())))
    assert relerr(Ap.matvec(x).numpy(), yj) <= 1e-6


@pytest.mark.parametrize("dtype_name,slack",
                         [("float64", 0), ("float32", 1)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("name", ["tet8r", "periodic"])
def test_jacobi_cg_matches_jax(name, dtype_name, slack):
    Aj, _csr, b = _matrices(name)
    Sj, Sp = _pair(name, dtype_name)
    tol = 1e-10 if dtype_name == "float64" else 1e-5
    bj = Sj.put_vector(b.astype(dtype_name))
    rj = j_cg_solve(Sj, bj, jnp.zeros_like(bj),
                    precond=JDiag(1.0 / Sj.diagonal_padded()), tol=tol,
                    maxiter=2000)
    bp = Sp.put_vector(b.astype(dtype_name))
    rp = cg_solve(Sp, bp, torch.zeros_like(bp),
                  precond=DiagonalPreconditioner(1.0 / Sp.diagonal_padded()),
                  tol=tol, maxiter=2000)
    assert rp.converged and bool(rj.converged)
    assert abs(rp.iterations - int(rj.iterations)) <= slack
    x = Sp.get_vector(rp.x).astype(np.float64)
    host = np.linalg.norm(b - Aj.matvec(x)) / np.linalg.norm(b)
    assert host <= (1e-9 if dtype_name == "float64" else 1e-4)
    if dtype_name == "float64":
        assert relerr(x, Sj.get_vector(rj.x)) <= 1e-10
