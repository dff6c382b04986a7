"""The port's preconditioners over the parts against the JAX package:
block-Schwarz AMG (one- and two-level), GMRES with Jacobi and with the
per-part ILU(0)/ILUT of the reference's ``mpirun`` configuration, the
global halo AMG, the ``level_info_out`` hook it is built from, and the
preconditioner comparison harness.

Setup as in ``test_torch_parallel.py`` (JAX on 8 virtual CPU devices, the
port's parts on the CPU, the same partition and vectors), all in f64.
Iteration counts are equal and answers agree to 1e-10 relative (summation
order through a solve, as there).  JAX rounds its packed ILU factors
through float32 (``ilu.py:115`` there) and the port keeps them in f64: on
its own factors the port takes JAX's iterations, and with JAX's factors
adopted part by part it lands on JAX's answer.  The halo AMG is the
single-device hierarchy laid out over the parts, so its count is within 2
of the port's single-device CG+AMG.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import domain_decomposed_pde_solver_tpu.parallel as J
from domain_decomposed_pde_solver_tpu.parallel.schwarz import (
    build_coarse_correction as j_coarse,
)
from domain_decomposed_pde_solver_tpu.solvers.precond.amg import (
    smoothed_aggregation_setup as j_sa_setup,
)
from domain_decomposed_pde_solver_tpu.utils.compare import (
    compare_preconditioners as j_compare,
)
import domain_decomposed_pde_solver_tpu_torch.parallel as T
from domain_decomposed_pde_solver_tpu_torch.ops.ell import ell_from_csr
from domain_decomposed_pde_solver_tpu_torch.parallel.schwarz import (
    BlockPrecond,
    build_coarse_correction,
)
from domain_decomposed_pde_solver_tpu_torch.solvers import cg_solve
from domain_decomposed_pde_solver_tpu_torch.solvers.precond.amg import (
    smoothed_aggregation_setup,
)
from domain_decomposed_pde_solver_tpu_torch.utils.compare import (
    compare_preconditioners,
)
from domain_decomposed_pde_solver_tpu_torch.utils.convert import ilu_from_numpy
from test_torch_parallel import inv_degree, partitioned
from torch_parity import port_csr, relerr

torch.set_num_threads(1)

DIMS = (5, 5, 5)
ILU_FIELDS = ("l_cols", "l_vals", "l_rows", "l_starts", "l_counts",
              "u_cols", "u_vals", "u_rows", "u_starts", "u_counts",
              "inv_diag")


def _x0(sy, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, size=sy.A.n_rows)


def _same(sy, opj, opt, rj, rt):
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    x = opt.get_vector(rt.x)
    assert relerr(x, opj.get_vector(rj.x)) <= 1e-10
    return x


@pytest.mark.parametrize("two_level", [False, True], ids=["one", "two"])
@pytest.mark.parametrize("nparts", [2, 4, 8])
def test_block_amg_cg_matches_jax(nparts, two_level):
    sy, _parts, pj, pt, opj, opt = partitioned(DIMS, nparts)
    Mj = J.build_block_amg(sy.A, pj, dtype=jnp.float64)
    Mt = T.build_block_amg(port_csr(sy), pt, dtype=torch.float64,
                           device="cpu")
    assert isinstance(Mt, BlockPrecond) and len(Mt.parts) == nparts
    # The common depth: every part's hierarchy has JAX's stacked levels.
    assert {len(m.levels) for m in Mt.parts} == {len(Mj.levels)}
    kw_j, kw_t = {}, {}
    if two_level:
        Aj_inv = j_coarse(sy.A, pj)
        At_inv = build_coarse_correction(port_csr(sy), pt, device="cpu")
        np.testing.assert_array_equal(At_inv.numpy(), np.asarray(Aj_inv))
        kw_j = dict(coarse_inv=Aj_inv, row_valid=jax.device_put(
            pj.row_valid.astype(np.float64),
            NamedSharding(opj.mesh, JP("parts"))))
        kw_t = dict(coarse_inv=At_inv,
                    row_valid=torch.from_numpy(pt.row_valid))
    x0 = _x0(sy)
    rj = J.sharded_cg_solve(opj, opj.put_vector(sy.b), opj.put_vector(x0),
                            block_amg=Mj, tol=1e-10, maxiter=500, **kw_j)
    rt = T.sharded_cg_solve(opt, opt.put_vector(sy.b), opt.put_vector(x0),
                            block_amg=Mt, tol=1e-10, maxiter=500, **kw_t)
    _same(sy, opj, opt, rj, rt)


def _unstack_ilu(Mj, nparts, n_local):
    """JAX's stacked per-part factors, part by part, in the port's apply."""
    return BlockPrecond(parts=[
        ilu_from_numpy(**{f: np.asarray(getattr(Mj, f))[p]
                          for f in ILU_FIELDS},
                       n_pad=n_local, dtype=torch.float64, device="cpu")
        for p in range(nparts)])


@pytest.mark.parametrize("precond", ["jacobi", "ilu0", "ilut"])
@pytest.mark.parametrize("nparts", [2, 4])
def test_sharded_gmres_matches_jax(nparts, precond):
    """GMRES(30) over the parts: Jacobi, and the per-part ILU(0)/ILUT of
    the reference's ``mpirun`` configuration."""
    sy, _parts, pj, pt, opj, opt = partitioned(DIMS, nparts)
    x0 = _x0(sy, 2)
    args_j = (opj, opj.put_vector(sy.b), opj.put_vector(x0))
    args_t = (opt, opt.put_vector(sy.b), opt.put_vector(x0))
    if precond == "jacobi":
        rj = J.sharded_gmres_solve(*args_j, precond_diag=opj.put_vector(
            inv_degree(sy)), tol=1e-10, maxiter=600)
        rt = T.sharded_gmres_solve(*args_t, precond_diag=opt.put_vector(
            inv_degree(sy)), tol=1e-10, maxiter=600)
        _same(sy, opj, opt, rj, rt)
        return
    Mj = J.build_block_ilu(sy.A, pj, dtype=jnp.float64, kind=precond)
    Mt = T.build_block_ilu(port_csr(sy), pt, dtype=torch.float64,
                           kind=precond, device="cpu")
    rj = J.sharded_gmres_solve(*args_j, block_precond=Mj, tol=1e-10,
                               maxiter=600)
    rt = T.sharded_gmres_solve(*args_t, block_precond=Mt, tol=1e-10,
                               maxiter=600)
    assert rt.converged and rt.iterations == int(rj.iterations)
    ra = T.sharded_gmres_solve(*args_t, block_precond=_unstack_ilu(
        Mj, nparts, pt.n_local), tol=1e-10, maxiter=600)
    _same(sy, opj, opt, rj, ra)
    # Block ILUT also preconditions CG through ``block_amg``.
    if precond == "ilut":
        rc = T.sharded_cg_solve(*args_t, block_amg=Mt, tol=1e-8, maxiter=600)
        assert rc.converged


@pytest.mark.parametrize("nparts", [2, 4, 8])
def test_halo_amg_cg_matches_jax(nparts):
    sy, _parts, pj, pt, opj, opt = partitioned(DIMS, nparts)
    hj = J.build_halo_amg(sy.A, pj, dtype=np.float64)
    ht = T.build_halo_amg(port_csr(sy), pt, dtype=torch.float64,
                          device="cpu")
    for f in ("agg", "tval", "scale", "inv_diag"):
        np.testing.assert_array_equal(getattr(ht, f), getattr(hj, f), f)
    assert (ht.n_c, ht.n_pad_c, ht.lmax, ht.smooth_steps) == (
        hj.n_c, hj.n_pad_c, hj.lmax, hj.smooth_steps)
    x0 = _x0(sy, 3)
    xj, rj = J.halo_amg_cg_solve(opj, hj, sy.b, x0, tol=1e-10, maxiter=200)
    xt, rt = T.halo_amg_cg_solve(opt, ht, sy.b, x0, tol=1e-10, maxiter=200)
    assert rt.converged and rt.iterations == int(rj.iterations)
    assert relerr(xt, xj) <= 1e-10
    # The single-device hierarchy on the port: the same count within 2.
    csr = port_csr(sy)
    A1 = ell_from_csr(csr, dtype=torch.float64, device="cpu")
    M1 = smoothed_aggregation_setup(csr, dtype=torch.float64, device="cpu")
    r1 = cg_solve(A1, A1.put_vector(sy.b), A1.put_vector(x0), precond=M1,
                  tol=1e-10, maxiter=200)
    assert r1.converged and abs(rt.iterations - r1.iterations) <= 2


def test_halo_amg_over_bsg_operator():
    """The halo AMG over the sliced-ELL partitioned operator (its plain
    version on the CPU): the ELL operator's iterations and answer."""
    sy, _parts, pj, pt, opj, opt = partitioned(DIMS, 4)
    ht = T.build_halo_amg(port_csr(sy), pt, dtype=torch.float64,
                          device="cpu")
    opb = T.BSGShardedOperator.from_plan(pt, opt.mesh)
    x0 = _x0(sy, 4)
    xe, re = T.halo_amg_cg_solve(opt, ht, sy.b, x0, tol=1e-10, maxiter=200)
    xb, rb = T.halo_amg_cg_solve(opb, ht, sy.b, x0, tol=1e-10, maxiter=200)
    assert rb.converged and rb.iterations == re.iterations
    assert relerr(xb, xe) <= 1e-10


@pytest.mark.parametrize("fine", ["none", "bsg"])
def test_level_info_out_matches_jax(fine):
    """The hook the halo AMG reads: per level, the raw aggregates, counts,
    diagonal, lmax and omega, equal to JAX's; with a sliced-ELL fine
    operator it turns the BSG chain off, as in JAX."""
    from domain_decomposed_pde_solver_tpu.ops.bsg import bsg_from_csr as j_bsg
    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import bsg_from_csr

    sy, *_ = partitioned(DIMS, 2)
    csr = port_csr(sy)
    kw_j, kw_t = {}, {}
    if fine == "bsg":
        kw_j["fine_operator"] = j_bsg(sy.A)
        kw_t["fine_operator"] = bsg_from_csr(csr, device="cpu")
    info_j, info_t = [], []
    Mj = j_sa_setup(sy.A, dtype=jnp.float64, level_info_out=info_j, **kw_j)
    Mt = smoothed_aggregation_setup(csr, dtype=torch.float64,
                                    level_info_out=info_t, device="cpu",
                                    **kw_t)
    assert len(info_t) == len(info_j) == len(Mt.levels) == len(Mj.levels)
    for a, b in zip(info_t, info_j):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_compare_preconditioners_matches_jax():
    sy, _parts, pj, pt, _opj, _opt = partitioned(DIMS, 4)
    got = compare_preconditioners(port_csr(sy), sy.b, tol=1e-8, plan=pt,
                                  device="cpu")
    want = j_compare(sy.A, sy.b, tol=1e-8, plan=pj)
    assert got == want
    assert got["schwarz_ilut"]["converged"] and got["schwarz_ilut"][
        "nparts"] == 4
