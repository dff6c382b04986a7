"""Transient heat flow and Lanczos: the port against the JAX package.

JAX's ``tests/test_transient.py`` cases run on the port; beside them the
two packages integrate the same flow on ``box_mesh(8, 8, 8, "TETRA4")``
(f64 DIA operators, CG to 1e-10 per step): the same total CG iterations,
and final states within 1e-10 relative (one f64 recurrence per step summed
in another order).  A permuted operator (sliced ELL with RCM ``perm``),
which JAX's transient does not lay out right, gives the DIA answer within
1e-8 relative (each step solved to 1e-10; the shifted diagonal of the
sliced-ELL operator is float32, so its Jacobi preconditioner rounds apart).
Lanczos extremes agree with JAX's within 1e-8 relative, also where the
Krylov space breaks down on a small invariant subspace.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from domain_decomposed_pde_solver_tpu.io import box_mesh as j_box_mesh
from domain_decomposed_pde_solver_tpu.models import (
    assemble_heat_system as j_assemble,
)
from domain_decomposed_pde_solver_tpu.models.transient import (
    transient_heat_solve as j_transient,
)
from domain_decomposed_pde_solver_tpu.ops import (
    choose_operator as j_choose_operator,
    dia_from_csr as j_dia_from_csr,
)
from domain_decomposed_pde_solver_tpu.ops.csr import CSRMatrix as j_csr
from domain_decomposed_pde_solver_tpu.solvers import (
    lanczos_extremes as j_lanczos,
)
from domain_decomposed_pde_solver_tpu_torch.models.transient import (
    ShiftedOperator,
    transient_heat_solve,
)
from domain_decomposed_pde_solver_tpu_torch.ops.bsg import bsg_from_csr
from domain_decomposed_pde_solver_tpu_torch.ops.dia import (
    choose_operator,
    dia_from_csr,
)
from domain_decomposed_pde_solver_tpu_torch.solvers import lanczos_extremes
from domain_decomposed_pde_solver_tpu_torch.utils.convert import csr_from_numpy
from torch_parity import port_csr, relerr

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _system():
    return j_assemble(j_box_mesh(8, 8, 8, elem_type="TETRA4"))


@pytest.fixture(scope="module")
def system():
    s = _system()
    return s, choose_operator(port_csr(s), dtype=torch.float64, device="cpu")


def test_single_step_matches_direct_solve(system):
    """One implicit-Euler step == direct solve of (I + dt A) u1 = u0 + dt b."""
    s, A = system
    dt = 0.1
    u0 = np.random.default_rng(0).uniform(0, 100, size=s.n_free)
    res = transient_heat_solve(s, A, dt=dt, n_steps=1, u0=u0, tol=1e-13)
    lhs = sp.eye(s.n_free) + dt * s.A.to_scipy()
    u1 = spla.spsolve(lhs.tocsc(), u0 + dt * s.b)
    np.testing.assert_allclose(res.u, u1, rtol=1e-9, atol=1e-9)


def test_flows_toward_steady_state(system):
    """The error against the steady solution decays monotonically."""
    s, A = system
    u_inf = spla.spsolve(s.A.to_scipy().tocsc(), s.b)
    res = transient_heat_solve(s, A, dt=0.1, n_steps=150, tol=1e-11,
                               record=True)
    errs = np.abs(res.history - u_inf).max(axis=1)
    assert errs[-1] < errs[0] * 2e-2
    assert np.all(np.diff(errs) <= 1e-9)


def test_warm_start_reduces_iterations(system):
    s, A = system
    res = transient_heat_solve(s, A, dt=0.05, n_steps=30, tol=1e-10,
                               callback=lambda k, t, u: None)
    assert res.total_cg_iterations < 30 * 25


def test_callback_fires_each_step(system):
    s, A = system
    seen = []
    transient_heat_solve(
        s, A, dt=0.1, n_steps=5,
        callback=lambda k, t, u: seen.append((k, round(t, 10), u.shape)),
    )
    assert [k for k, _, _ in seen] == [1, 2, 3, 4, 5]
    assert all(sh == (s.n_free,) for _, _, sh in seen)


@pytest.mark.parametrize("u0_seed", [None, 4])
def test_flow_matches_jax(system, u0_seed):
    s, A = system
    u0 = (None if u0_seed is None else
          np.random.default_rng(u0_seed).uniform(0, 500, size=s.n_free))
    kw = dict(dt=0.2, n_steps=12, tol=1e-10, u0=u0, record=True)
    res = transient_heat_solve(s, A, **kw)
    jres = j_transient(s, j_choose_operator(s.A, dtype=jnp.float64), **kw)
    assert res.total_cg_iterations == jres.total_cg_iterations
    np.testing.assert_array_equal(res.times, jres.times)
    assert relerr(res.u, jres.u) <= 1e-10
    assert relerr(res.history, jres.history) <= 1e-10


def test_permuted_operator_gives_the_identity_layout_answer(system):
    s, A = system
    P = bsg_from_csr(port_csr(s), storage="float64", device="cpu")
    assert P.perm is not None
    assert not torch.equal(P.perm, torch.arange(s.n_free))
    # The shifted diagonal's pad slots, found through the layout: the
    # permuted operator maps its rows elsewhere than to [0, n_rows).
    d = ShiftedOperator(A=P, dt=0.2).diagonal_padded(fill=7.0)
    real = P.put_vector(np.ones(s.n_free)) != 0
    assert bool((d[~real] == 7.0).all()) and bool((d[real] != 7.0).all())
    kw = dict(dt=0.2, n_steps=6, tol=1e-10)
    assert relerr(transient_heat_solve(s, P, **kw).u,
                  transient_heat_solve(s, A, **kw).u) <= 1e-8


def _z0(n_rows, n_pad, seed=0):
    z0 = np.zeros(n_pad)
    z0[:n_rows] = np.random.default_rng(seed).standard_normal(n_rows)
    return z0


def test_lanczos_matches_jax(system):
    s, A = system
    z0 = _z0(s.n_free, A.n_pad)
    res = lanczos_extremes(A, torch.from_numpy(z0), k=40)
    jres = j_lanczos(j_choose_operator(s.A, dtype=jnp.float64),
                     jnp.asarray(z0), k=40)
    assert abs(res.lmin - float(jres.lmin)) <= 1e-8 * abs(float(jres.lmin))
    assert abs(res.lmax - float(jres.lmax)) <= 1e-8 * abs(float(jres.lmax))
    assert abs(res.condition - float(jres.condition)) <= 1e-8 * float(
        jres.condition)
    ev = np.linalg.eigvalsh(s.A.to_scipy().toarray())
    assert ev[0] <= res.lmin and res.lmax <= ev[-1] * (1 + 1e-12)


def test_lanczos_breakdown_on_an_invariant_subspace():
    """A diagonal operator with 5 distinct eigenvalues: the Krylov space is
    invariant after 5 steps, and the masked steps after it add no spurious
    Ritz value; both ends are exact."""
    n = 400
    diag = 1.0 + np.arange(n) % 5
    csr = sp.diags(diag).tocsr()
    A = dia_from_csr(csr_from_numpy(csr.indptr, csr.indices, csr.data,
                                    csr.shape),
                     dtype=torch.float64, storage="full", device="cpu")
    jA = j_dia_from_csr(j_csr(csr.indptr, csr.indices, csr.data, csr.shape),
                        dtype=jnp.float64)
    z0 = _z0(n, A.n_pad, seed=2)
    res = lanczos_extremes(A, torch.from_numpy(z0), k=20)
    jres = j_lanczos(jA, jnp.asarray(z0), k=20)
    assert abs(res.lmin - 1.0) <= 1e-10 and abs(res.lmax - 5.0) <= 1e-10
    assert abs(res.lmin - float(jres.lmin)) <= 1e-8 * 1.0
    assert abs(res.lmax - float(jres.lmax)) <= 1e-8 * 5.0
