"""The AMG's options against the JAX package: the damped-Jacobi smoother,
several V-cycles per apply, the opt-outs of the sliced-ELL (BSG) chain,
and the parallel builders with ``smoother="jacobi"``.

Both packages get the same assembled arrays (refined tet boxes of
``tests/torch_parity.py``; structured boxes of ``test_torch_slab.py`` and
``test_torch_slabpadamg.py`` for the slab builders) and the same
numpy-seeded vectors.  JAX's ``cycles`` is a field of its preconditioner,
not a set-up keyword, so both are set with ``dataclasses.replace``.

Tolerances, each from summation order: one apply agrees to 1e-12
relative on the single-device identity-space hierarchy (every level the
same operators, added in another order) and to 1e-10 where a sliced-ELL
fine operator's permuted space is crossed (as in
``test_torch_solvers.py``); CG in f64 takes JAX's iterations and lands on
its answer to 1e-10.  The slab-pad AMG is float32 only (its kernel's
type): there, as in ``test_torch_slabpadamg.py``, within one iteration
and 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import domain_decomposed_pde_solver_tpu.parallel as J
from domain_decomposed_pde_solver_tpu.ops.bsg import bsg_from_csr as j_bsg
from domain_decomposed_pde_solver_tpu.ops.dia import choose_operator as j_choose
from domain_decomposed_pde_solver_tpu.solvers.cg import cg_solve as j_cg_solve
from domain_decomposed_pde_solver_tpu.solvers.precond import amg as j_amg
import domain_decomposed_pde_solver_tpu_torch.parallel as T
from domain_decomposed_pde_solver_tpu_torch.ops.bsg import BSGMatrix, bsg_from_csr
from domain_decomposed_pde_solver_tpu_torch.ops.dia import choose_operator
from domain_decomposed_pde_solver_tpu_torch.ops.ell import ELLMatrix
from domain_decomposed_pde_solver_tpu_torch.solvers.cg import cg_solve
from domain_decomposed_pde_solver_tpu_torch.solvers.precond import amg as p_amg
from test_torch_parallel import partitioned
from test_torch_slab import structured, x0_of
from test_torch_slabpadamg import hierarchies as slab_pad_inputs
from torch_parity import MESH_DIMS, jax_problem, port_csr, rand, relerr

torch.set_num_threads(1)

# Lowered thresholds: the sliced-ELL chain engages at test size.
CHAIN = dict(bsg_level_min_rows=20, bsg_transfer_min_rows=0, coarse_size=12)
OPT_OUTS = {
    "chain": {},
    "no-mid-levels": dict(bsg_mid_levels=False),
    "no-transfers": dict(bsg_transfers=False),
    "neither": dict(bsg_mid_levels=False, bsg_transfers=False),
}


def _identity_space(dims, **kw):
    """JAX's and the port's operators and hierarchies in f64 with no fine
    operator (the identity padded space)."""
    _mesh, sy = jax_problem(dims)
    csr = port_csr(sy)
    Aj = j_choose(sy.A, dtype=jnp.float64)
    Ap = choose_operator(csr, dtype=torch.float64, device="cpu")
    Mj = j_amg.smoothed_aggregation_setup(sy.A, dtype=jnp.float64, **kw)
    Mp = p_amg.smoothed_aggregation_setup(csr, dtype=torch.float64,
                                          device="cpu", **kw)
    return sy, Aj, Ap, Mj, Mp


def _same_solve(sy, Aj, Ap, Mj, Mp, tol=1e-10):
    b = sy.b / np.abs(sy.b).max()
    bj = Aj.put_vector(b, dtype=jnp.float64)
    bp = Ap.put_vector(b, dtype=torch.float64)
    rj = j_cg_solve(Aj, bj, jnp.zeros_like(bj), precond=Mj, tol=tol,
                    maxiter=300)
    rp = cg_solve(Ap, bp, torch.zeros_like(bp), precond=Mp, tol=tol,
                  maxiter=300)
    assert rp.converged and bool(rj.converged)
    assert rp.iterations == int(rj.iterations)
    x = Ap.get_vector(rp.x)
    assert relerr(x, Aj.get_vector(rj.x)) <= 1e-10
    assert np.linalg.norm(b - sy.A.matvec(x)) <= 1e-9 * np.linalg.norm(b)
    return rp.iterations


def _same_apply(Aj, Ap, Mj, Mp, n, limit, seed=41):
    r = rand(n, seed=seed)
    zj = Aj.get_vector(Mj(Aj.put_vector(r, dtype=jnp.float64)))
    zp = Ap.get_vector(Mp(Ap.put_vector(r, dtype=torch.float64)))
    assert relerr(zp, zj) <= limit


@pytest.mark.parametrize("smoother,cycles",
                         [("jacobi", 1), ("jacobi", 2), ("jacobi", 3),
                          ("chebyshev", 2)])
@pytest.mark.parametrize("dims", MESH_DIMS, ids=lambda d: "x".join(map(str, d)))
def test_smoother_and_cycles_match_jax(dims, smoother, cycles):
    sy, Aj, Ap, Mj, Mp = _identity_space(dims, smoother=smoother)
    assert Mp.smoother == Mj.smoother == smoother
    Mj = dataclasses.replace(Mj, cycles=cycles)
    Mp = dataclasses.replace(Mp, cycles=cycles)
    _same_apply(Aj, Ap, Mj, Mp, sy.A.n_rows, 1e-12)
    _same_solve(sy, Aj, Ap, Mj, Mp)


def test_more_cycles_never_take_more_iterations():
    sy, Aj, Ap, Mj, Mp = _identity_space(MESH_DIMS[0], smoother="jacobi")
    its = [_same_solve(sy, Aj, Ap, dataclasses.replace(Mj, cycles=c),
                       dataclasses.replace(Mp, cycles=c)) for c in (1, 2, 3)]
    assert its[0] >= its[1] >= its[2]


def test_jacobi_smoother_sweeps():
    """One level, two sweeps from zero: ``x1 = w D^-1 b`` (the first
    product skipped), ``x2 = x1 + w D^-1 (b - A x1)``, w = 2/3."""
    _sy, _Aj, _Ap, _Mj, Mp = _identity_space(MESH_DIMS[1],
                                             smoother="jacobi")
    lvl = Mp.levels[0]
    b = torch.from_numpy(rand(lvl.A.n_pad, seed=3))
    w = 2.0 / 3.0
    x1 = w * lvl.inv_diag * b
    want = x1 + w * lvl.inv_diag * (b - lvl.A.matvec(x1))
    got = Mp._smooth(lvl, torch.zeros_like(b), b, x_zero=True)
    assert torch.equal(got, want)


def _chain(dims, case, smoother="chebyshev"):
    _mesh, sy = jax_problem(dims)
    csr = port_csr(sy)
    kw = dict(CHAIN, **OPT_OUTS[case], smoother=smoother)
    Aj = j_bsg(sy.A)
    Ap = bsg_from_csr(csr, device="cpu")
    Mj = j_amg.smoothed_aggregation_setup(sy.A, dtype=jnp.float64,
                                          fine_operator=Aj, **kw)
    Mp = p_amg.smoothed_aggregation_setup(csr, dtype=torch.float64,
                                          fine_operator=Ap, device="cpu",
                                          **kw)
    return sy, Aj, Ap, Mj, Mp


@pytest.mark.parametrize("case", sorted(OPT_OUTS))
@pytest.mark.parametrize("dims", MESH_DIMS, ids=lambda d: "x".join(map(str, d)))
def test_bsg_chain_opt_outs_match_jax(dims, case):
    sy, Aj, Ap, Mj, Mp = _chain(dims, case)
    assert [l.n_rows for l in Mp.levels] == [l.n_rows for l in Mj.levels]
    assert len(Mp.levels) >= 2
    mid = OPT_OUTS[case].get("bsg_mid_levels", True)
    transfers = OPT_OUTS[case].get("bsg_transfers", True)
    for k, (lj, lp) in enumerate(zip(Mj.levels, Mp.levels)):
        assert float(lj.lmax) == float(lp.lmax)
        # The port's levels are sliced ELL either way; JAX's coarse levels
        # are BSG on the chain, Split-ELL or ELL off it.
        assert isinstance(lp.A, BSGMatrix)
        assert isinstance(lj.A, type(Aj)) == (mid or k == 0)
        kind_j, kind_p = type(lj.P).__name__, type(lp.P).__name__
        if mid and transfers:
            assert kind_p == kind_j == "BSGTransferProlongator"
        elif mid or k == 0:
            assert kind_p == kind_j == "FactoredProlongator"
        else:  # explicit ELL P and R off the chain
            assert isinstance(lp.P, ELLMatrix) and kind_j == "ELLMatrix"
    _same_apply(Aj, Ap, Mj, Mp, sy.A.n_rows, 1e-10)
    _same_solve(sy, Aj, Ap, Mj, Mp)


def test_bsg_chain_opt_outs_with_jacobi_and_cycles():
    sy, Aj, Ap, Mj, Mp = _chain(MESH_DIMS[0], "neither", smoother="jacobi")
    Mj = dataclasses.replace(Mj, cycles=2)
    Mp = dataclasses.replace(Mp, cycles=2)
    _same_apply(Aj, Ap, Mj, Mp, sy.A.n_rows, 1e-10)
    _same_solve(sy, Aj, Ap, Mj, Mp)


# ---------------------------------------------------------------------------
# The parallel builders forward the set-up keywords
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nparts", [2, 4])
def test_block_amg_jacobi_matches_jax(nparts):
    sy, _parts, pj, pt, opj, opt = partitioned((5, 5, 5), nparts)
    Mj = J.build_block_amg(sy.A, pj, dtype=jnp.float64, smoother="jacobi")
    Mt = T.build_block_amg(port_csr(sy), pt, dtype=torch.float64,
                           device="cpu", smoother="jacobi")
    assert Mj.smoother == "jacobi"
    assert {m.smoother for m in Mt.parts} == {"jacobi"}
    x0 = x0_of(sy.A.n_rows)
    rj = J.sharded_cg_solve(opj, opj.put_vector(sy.b), opj.put_vector(x0),
                            block_amg=Mj, tol=1e-10, maxiter=500)
    rt = T.sharded_cg_solve(opt, opt.put_vector(sy.b), opt.put_vector(x0),
                            block_amg=Mt, tol=1e-10, maxiter=500)
    assert rt.converged and rt.iterations == int(rj.iterations)
    assert relerr(opt.get_vector(rt.x), opj.get_vector(rj.x)) <= 1e-10
    # Jacobi smoothing changes the hierarchy's apply.
    Mc = T.build_block_amg(port_csr(sy), pt, dtype=torch.float64,
                           device="cpu")
    rc = T.sharded_cg_solve(opt, opt.put_vector(sy.b), opt.put_vector(x0),
                            block_amg=Mc, tol=1e-10, maxiter=500)
    assert not torch.equal(rc.x, rt.x)


@pytest.mark.parametrize("nparts", [2, 4])
def test_halo_amg_jacobi_matches_jax(nparts):
    """The fine level smooths with Chebyshev whatever ``smoother`` says,
    as JAX's ``HaloAMG._smooth``; the coarse tail takes Jacobi."""
    sy, _parts, pj, pt, opj, opt = partitioned((5, 5, 5), nparts)
    hj = J.build_halo_amg(sy.A, pj, dtype=np.float64, smoother="jacobi")
    ht = T.build_halo_amg(port_csr(sy), pt, dtype=torch.float64,
                          device="cpu", smoother="jacobi")
    assert ht.tail.smoother == hj.tail.smoother == "jacobi"
    x0 = x0_of(sy.A.n_rows, 3)
    xj, rj = J.halo_amg_cg_solve(opj, hj, sy.b, x0, tol=1e-10, maxiter=200)
    xt, rt = T.halo_amg_cg_solve(opt, ht, sy.b, x0, tol=1e-10, maxiter=200)
    assert rt.converged and rt.iterations == int(rj.iterations)
    assert relerr(xt, xj) <= 1e-10


@pytest.mark.parametrize("nparts", [2, 4])
def test_slab_amg_jacobi_matches_jax(nparts):
    sy, dims, A = structured("TETRA4")
    sj = J.build_slab_amg(sy.A, dims, nparts, dtype=np.float64,
                          smoother="jacobi")
    st = T.build_slab_amg(A, dims, nparts, dtype=np.float64, device="cpu",
                          smoother="jacobi")
    assert st.tail.smoother == sj.tail.smoother == "jacobi"
    x0 = x0_of(sy.n_free)
    xj, rj = J.slab_amg_cg_solve(sj, sy.b, x0, tol=1e-10)
    xt, rt = T.slab_amg_cg_solve(st, sy.b, x0, tol=1e-10)
    assert rt.converged and rt.iterations == int(rj.iterations)
    assert relerr(xt, xj) <= 1e-10


def test_slab_pad_amg_jacobi_matches_jax():
    sy, dims, cheb_j, cheb_t = slab_pad_inputs(2)
    sj = J.build_slab_pad_amg(sy.A, dims, 2, pad_op=cheb_j.pad_op,
                              smoother="jacobi")
    st = T.build_slab_pad_amg(port_csr(sy), dims, 2, pad_op=cheb_t.pad_op,
                              smoother="jacobi")
    assert st.tail.smoother == sj.tail.smoother == "jacobi"
    x0 = np.zeros(sy.n_free)
    xj, rj = J.slab_pad_amg_cg_solve(sj, sy.b, x0, tol=1e-6)
    xt, rt = T.slab_pad_amg_cg_solve(st, sy.b, x0, tol=1e-6)
    assert rt.converged and bool(rj.converged)
    assert abs(rt.iterations - int(rj.iterations)) <= 1
    assert relerr(xt, xj) <= 1e-4
