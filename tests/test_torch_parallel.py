"""The port's domain-decomposed solve against the JAX package: halo plans,
node ownership, the partitioned operators, and CG, chunked CG and the
power method over the parts.

JAX runs each part on one of the 8 virtual CPU devices that
``tests/conftest.py`` forces; the port runs every part on the CPU in one
process (``make_device_mesh(P, ["cpu"])``).  Both get the same refined tet
boxes (``tests/torch_parity.py``), the same partition (JAX's
``partition_graph``) and the same numpy-seeded vectors.

Tolerances, each from summation order: the host plans are numpy copies and
equal bit for bit; a product over the parts adds the same f64 products in
another order (XLA's row sums against PyTorch's), 1e-13 relative; a solve
amplifies that by at most the condition number of these small systems
(~1e3), so answers agree to 1e-10 relative with equal iteration counts;
the power method's lambda to 1e-12.  A chunked solve is the unbroken
solve's recurrence, so it equals it bit for bit.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import domain_decomposed_pde_solver_tpu.parallel as J
from domain_decomposed_pde_solver_tpu.models import assemble_full_laplacian
from domain_decomposed_pde_solver_tpu.ops import coo_to_csr as j_coo_to_csr
from domain_decomposed_pde_solver_tpu.parallel.sharded import (
    AXIS as J_AXIS,
    _local_spmv as j_local_spmv,
)
import domain_decomposed_pde_solver_tpu_torch.parallel as T
from domain_decomposed_pde_solver_tpu_torch.io import (
    box_mesh as p_box_mesh,
    refine_uniform as p_refine_uniform,
)
from domain_decomposed_pde_solver_tpu_torch.models.laplacian import (
    assemble_full_laplacian as p_full_laplacian,
)
from domain_decomposed_pde_solver_tpu_torch.ops.bsg import spmv_plain
from domain_decomposed_pde_solver_tpu_torch.parallel.sharded import (
    halo_exchange,
    psum,
    psum_dot,
)
from domain_decomposed_pde_solver_tpu_torch.utils.convert import csr_from_numpy
from torch_parity import jax_problem, port_csr, relerr

torch.set_num_threads(1)

PARTS = [2, 4, 8]
DIMS = (5, 5, 5)  # refined: 826 free DOF
PLAN_FIELDS = ("perm", "part_of_row", "local_of_row", "ell_cols", "ell_vals",
               "send_idx", "row_valid")


def adjacency(A):
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    off = rows != A.indices
    return j_coo_to_csr(rows[off], A.indices[off], np.ones(int(off.sum())),
                        A.shape, sum_dups=False)


@functools.lru_cache(maxsize=None)
def partitioned(dims, nparts):
    """JAX's and the port's plans and ELL operators of the refined box."""
    mesh, sy = jax_problem(dims)
    parts = J.partition_graph(adjacency(sy.A), nparts,
                              coords=mesh.coords[sy.free_to_node])
    pj = J.build_halo_plan(sy.A, parts, nparts)
    pt = T.build_halo_plan(port_csr(sy), parts, nparts)
    opj = J.ShardedOperator.from_plan(pj, J.make_device_mesh(nparts))
    opt = T.ShardedOperator.from_plan(pt, T.make_device_mesh(nparts, ["cpu"]))
    return sy, parts, pj, pt, opj, opt


def inv_degree(sy):
    return 1.0 / np.where(sy.degree > 0, sy.degree, 1.0)


@pytest.mark.parametrize("dims", [(4, 4, 4), (6, 5, 4)])
@pytest.mark.parametrize("nparts", PARTS)
def test_halo_plan_matches_jax(dims, nparts):
    _sy, _parts, pj, pt, _opj, _opt = partitioned(dims, nparts)
    assert (pt.nparts, pt.n_global, pt.n_local, pt.halo_width) == (
        pj.nparts, pj.n_global, pj.n_local, pj.halo_width)
    for f in PLAN_FIELDS:
        a, b = getattr(pt, f), getattr(pj, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    x = np.random.default_rng(3).normal(size=pj.n_global)
    np.testing.assert_array_equal(pt.scatter_vector(x), pj.scatter_vector(x))
    np.testing.assert_array_equal(pt.gather_vector(pt.scatter_vector(x)), x)


@pytest.mark.parametrize("nparts", PARTS)
def test_node_ownership_matches_jax(nparts):
    mesh, _sy = jax_problem(DIMS)
    elem_parts = np.random.default_rng(nparts).integers(
        0, nparts, size=mesh.num_elem)
    port_mesh = p_refine_uniform(p_box_mesh(*DIMS, elem_type="TETRA4"), 1)
    np.testing.assert_array_equal(port_mesh.coords, mesh.coords)
    got = T.node_ownership_from_element_partition(port_mesh, elem_parts,
                                                  nparts)
    want = J.node_ownership_from_element_partition(mesh, elem_parts, nparts)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _jax_matvec(opj, x_host):
    def body(cols, vals, send_idx, x_blk):
        return j_local_spmv(cols[0], vals[0], send_idx[0], x_blk[0])[None]

    y = jax.shard_map(body, mesh=opj.mesh, in_specs=(JP(J_AXIS),) * 4,
                      out_specs=JP(J_AXIS), check_vma=False)(
        opj.cols, opj.vals, opj.send_idx, opj.put_vector(x_host))
    return opj.get_vector(y)


@pytest.mark.parametrize("kind", ["ell", "bsg"])
@pytest.mark.parametrize("nparts", PARTS)
def test_sharded_matvec_matches_jax(nparts, kind):
    """ELL and sliced-ELL (through its plain version on the CPU) local
    products against JAX's ``_local_spmv`` under ``shard_map``, f64."""
    sy, _parts, _pj, pt, opj, opt = partitioned(DIMS, nparts)
    if kind == "bsg":
        opt = T.BSGShardedOperator.from_plan(pt, opt.mesh)
        # Graph-Laplacian values are bf16-exact: JAX's storage rule.
        assert all(b.storage == "bfloat16" for b in opt.parts)
        assert len(opt.parts) == nparts
    x = np.random.default_rng(7).normal(size=sy.A.n_rows)
    got = opt.get_vector(opt.matvec(opt.put_vector(x)))
    assert relerr(got, _jax_matvec(opj, x)) <= 1e-13
    assert relerr(got, sy.A.matvec(x)) <= 1e-13


@pytest.mark.parametrize("nparts", PARTS)
def test_bsg_blocks_halo_rows_are_zero(nparts):
    """Each part's square block over its extended-local space: rows past
    ``n_local`` (the ``P*H`` halo rows and the padding) are slices of width
    0 and give exactly 0; the owned rows are the ELL product's."""
    sy, _parts, _pj, pt, _opj, opt = partitioned(DIMS, nparts)
    opb = T.BSGShardedOperator.from_plan(pt, opt.mesh)
    x = opb.put_vector(np.random.default_rng(5).normal(size=sy.A.n_rows))
    xe = opb.extended(x)
    n = pt.n_local
    n_ext = n + nparts * pt.halo_width
    assert opb.parts[0].n_pad >= n_ext and opb.parts[0].n_pad % 1024 == 0
    np.testing.assert_array_equal(
        xe[:, n:n_ext].numpy(), halo_exchange(x, opb.halo_idx).numpy())
    assert not xe[:, n_ext:].any()
    ys = opt.matvec(x)
    for p, blk in enumerate(opb.parts):
        y = spmv_plain(blk, xe[p])
        assert not y[n:].any()
        assert relerr(y[:n].numpy(), ys[p].numpy()) <= 1e-13
        widths = (blk.slice_ptr[1:] - blk.slice_ptr[:-1]) // 32
        assert not widths[-(-n // 32):].any()  # slices wholly past n_local


def test_halo_exchange_and_psum():
    """``halo[p, q, s] = x[q, send_idx[q, p, s]]``, and the part-ordered
    sum."""
    _sy, _parts, _pj, pt, _opj, opt = partitioned(DIMS, 4)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, pt.n_local)))
    halo = halo_exchange(x, opt.halo_idx).view(4, 4, pt.halo_width)
    for p in range(4):
        for q in range(4):
            np.testing.assert_array_equal(
                halo[p, q].numpy(), x[q].numpy()[pt.send_idx[q, p]])
    d = torch.tensor([1e16, 1.0, -1e16, 1.0], dtype=torch.float64)
    assert float(psum(d)) == ((1e16 + 1.0) - 1e16) + 1.0
    y = torch.from_numpy(np.random.default_rng(4).normal(size=(4, pt.n_local)))
    assert abs(float(psum_dot(x, y)) - float((x * y).sum())) <= 1e-12 * float(
        (x.abs() * y.abs()).sum())


def test_make_device_mesh():
    m = T.make_device_mesh(8, ["cpu"])
    assert (m.nparts, m.device, m.shape) == (8, torch.device("cpu"),
                                             {"parts": 8})
    assert T.make_device_mesh(3, ["cpu", "cpu", "cpu", "cuda:0"]).nparts == 3
    with pytest.raises(NotImplementedError, match="initialize_multihost"):
        T.make_device_mesh(2, ["cpu", "cuda:0"])
    with pytest.raises(ValueError):
        T.make_device_mesh(0, ["cpu"])


def _cg_pair(nparts, precond):
    sy, _parts, _pj, _pt, opj, opt = partitioned(DIMS, nparts)
    kw_j, kw_t = {}, {}
    if precond in ("jacobi", "chebyshev"):
        kw_j["precond_diag"] = opj.put_vector(inv_degree(sy))
        kw_t["precond_diag"] = opt.put_vector(inv_degree(sy))
    if precond == "chebyshev":
        kw_j["cheb_lmax"] = kw_t["cheb_lmax"] = 2.0
    x0 = np.random.default_rng(nparts).uniform(-1, 1, size=sy.A.n_rows)
    rj = J.sharded_cg_solve(opj, opj.put_vector(sy.b), opj.put_vector(x0),
                            tol=1e-10, maxiter=2000, **kw_j)
    rt = T.sharded_cg_solve(opt, opt.put_vector(sy.b), opt.put_vector(x0),
                            tol=1e-10, maxiter=2000, **kw_t)
    return sy, opj, opt, rj, rt


@pytest.mark.parametrize("precond", ["none", "jacobi", "chebyshev"])
@pytest.mark.parametrize("nparts", PARTS)
def test_sharded_cg_matches_jax(nparts, precond):
    sy, opj, opt, rj, rt = _cg_pair(nparts, precond)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    assert abs(rt.relres - float(rj.relres)) <= 1e-3 * float(rj.relres)
    x = opt.get_vector(rt.x)
    assert relerr(x, opj.get_vector(rj.x)) <= 1e-10
    assert np.linalg.norm(sy.b - sy.A.matvec(x)) <= 1e-9 * np.linalg.norm(
        sy.b)


@pytest.mark.parametrize("precond", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("nparts", [2, 8])
def test_sharded_cg_chunk_is_the_unbroken_solve(nparts, precond):
    """Chunks of 7 iterations threading ``(r, p, rz)`` land on the
    unbroken solve's iterate bit for bit, in as many iterations."""
    sy, opj, opt, rj, rt = _cg_pair(nparts, precond)
    inv_d = opt.put_vector(inv_degree(sy))
    cheb = 2.0 if precond == "chebyshev" else None
    b = opt.put_vector(sy.b)
    x = opt.put_vector(np.random.default_rng(nparts).uniform(
        -1, 1, size=sy.A.n_rows))
    state, total = None, 0
    while total < 2000:
        res, state = T.sharded_cg_chunk(opt, b, x, state, precond_diag=inv_d,
                                        cheb_lmax=cheb, tol=1e-10, maxiter=7)
        x = res.x
        total += res.iterations
        if res.converged:
            break
    assert total == rt.iterations == int(rj.iterations)
    assert torch.equal(x, rt.x)


@pytest.mark.parametrize("nparts", PARTS)
def test_sharded_power_method_matches_jax(nparts):
    """The full-mesh Laplacian (``ExodusMatrixTest`` under ``mpirun``)."""
    mesh, _sy = jax_problem(DIMS)
    L = assemble_full_laplacian(mesh)
    parts = J.partition_graph(adjacency(L), nparts, coords=mesh.coords)
    pj = J.build_halo_plan(L, parts, nparts)
    Lp = csr_from_numpy(L.indptr, L.indices, L.data, L.shape)
    pt = T.build_halo_plan(Lp, parts, nparts)
    opj = J.ShardedOperator.from_plan(pj, J.make_device_mesh(nparts))
    opt = T.ShardedOperator.from_plan(pt, T.make_device_mesh(nparts, ["cpu"]))
    z0 = np.random.default_rng(0).uniform(size=L.n_rows)
    rj = J.sharded_power_method(opj, opj.put_vector(z0), maxiter=300,
                                tol=1e-6, check_every=25)
    rt = T.sharded_power_method(opt, opt.put_vector(z0), maxiter=300,
                                tol=1e-6, check_every=25)
    assert rt.iterations == int(rj.iterations)
    assert rt.converged == bool(rj.converged)
    assert abs(rt.eigenvalue - float(rj.eigenvalue)) <= 1e-12 * abs(
        float(rj.eigenvalue))
    assert relerr(opt.get_vector(rt.eigenvector),
                  opj.get_vector(rj.eigenvector)) <= 1e-10
    # The port's own assembly gives the same operator.
    Pl = p_full_laplacian(p_refine_uniform(
        p_box_mesh(*DIMS, elem_type="TETRA4"), 1))
    np.testing.assert_array_equal(Pl.data, L.data)
