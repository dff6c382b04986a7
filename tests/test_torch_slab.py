"""The port's slab DIA and lattice-stencil engines against the JAX
package: ``build_slab_plan``, ``build_slab_stencil``, the two slab
products, ``slab_cg_solve`` (Jacobi, the brick-Schwarz preconditioner of
``build_slab_brick_precond``), ``slab_stencil_cg_solve`` and the global
slab AMG (``build_slab_amg``, ``slab_amg_cg_solve``).

JAX runs each part on one of the 8 virtual CPU devices that
``tests/conftest.py`` forces; the port drives every part on the CPU from
one controller.  Both get the same structured boxes, assembled once by the
JAX package, and the same numpy-seeded vectors.  The grids are uneven, so
the last slab is short or holds padding.

Tolerances, each from summation order: host plans and set-up arrays equal
bit for bit; a slab product adds the same f64 products in another order,
1e-13 relative; an f64 solve takes JAX's iterations and its answer agrees
to 1e-10 relative (the condition number of these small systems times the
rounding).  ``slab_stencil_cg_solve`` is float32 in JAX whatever the
operator's dtype, so there the counts agree within 1 and the answers to
1e-4.  The slab AMG's count equals the single-device AMG's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import domain_decomposed_pde_solver_tpu.parallel as J
from domain_decomposed_pde_solver_tpu.io import box_mesh, refine_uniform
from domain_decomposed_pde_solver_tpu.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu.ops import choose_operator as j_choose
from domain_decomposed_pde_solver_tpu.parallel.sharded import AXIS
from domain_decomposed_pde_solver_tpu.parallel.slab import (
    SlabDIAOperator as JSlabDIA,
    SlabStencilOperator as JSlabStencil,
)
from domain_decomposed_pde_solver_tpu.solvers.precond.amg import (
    infer_free_grid,
)
import domain_decomposed_pde_solver_tpu_torch.parallel as T
from domain_decomposed_pde_solver_tpu_torch.ops.dia import (
    choose_operator,
    dia_from_csr,
)
from domain_decomposed_pde_solver_tpu_torch.parallel.slab import (
    SlabDIAOperator,
    neighbour_strips,
)
from domain_decomposed_pde_solver_tpu_torch.solvers.cg import cg_solve
from domain_decomposed_pde_solver_tpu_torch.solvers.precond.amg import (
    smoothed_aggregation_setup,
)
from domain_decomposed_pde_solver_tpu_torch.utils.convert import (
    slab_dia_plan_from_numpy,
)
from torch_parity import port_csr, relerr

torch.set_num_threads(1)

PARTS = [2, 4]
# Free grids (8, 9, 13) and (9, 9, 11): P = 2 and 4 leave a short last slab.
BOXES = {"TETRA4": (9, 8, 12), "HEX8": (10, 8, 10)}


@functools.lru_cache(maxsize=None)
def structured(elem):
    """(JAX system, free grid, port CSR) of a structured box."""
    mesh = box_mesh(*BOXES[elem], elem_type=elem)
    sy = assemble_heat_system(mesh)
    dims = infer_free_grid(mesh, sy.free_to_node)
    assert dims is not None and int(np.prod(dims)) == sy.n_free
    return sy, dims, port_csr(sy)


def mesh_of(P):
    return T.make_device_mesh(P, ["cpu"])


def jax_over_parts(fn, *stacked):
    """``fn`` on every part's block of the ``(P, ...)`` arrays, one part per
    virtual device (``shard_map``); returns the stacked result."""
    P_ = stacked[0].shape[0]
    dev_mesh = J.make_device_mesh(P_)
    sh = NamedSharding(dev_mesh, JP(AXIS))
    ins = [jax.device_put(jnp.asarray(a), sh) for a in stacked]

    def body(*blocks):
        return fn(*[blk[0] for blk in blocks])[None]

    return np.asarray(jax.shard_map(
        body, mesh=dev_mesh, in_specs=tuple(JP(AXIS) for _ in ins),
        out_specs=JP(AXIS), check_vma=False)(*ins))


def x0_of(n, seed=1):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, n)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("align", ["rows", "layers"])
@pytest.mark.parametrize("nparts", PARTS)
@pytest.mark.parametrize("elem", sorted(BOXES))
def test_slab_plan_equals_jax(elem, nparts, align, dtype):
    sy, dims, A = structured(elem)
    row_align = 8 if align == "rows" else dims[0] * dims[1]
    pj = J.build_slab_plan(sy.A, nparts, dtype=dtype, row_align=row_align)
    pt = T.build_slab_plan(A, nparts, dtype=dtype, row_align=row_align)
    for f in ("nparts", "n", "slab", "halo", "offsets"):
        assert getattr(pt, f) == getattr(pj, f), f
    assert pt.data.dtype == pj.data.dtype
    np.testing.assert_array_equal(pt.data, pj.data)
    # From the port's DIAMatrix (bfloat16 storage of the Laplacian) too.
    dia = dia_from_csr(A, dtype=torch.float32, device="cpu")
    pd = T.build_slab_plan(dia, nparts, dtype=dtype, row_align=row_align)
    np.testing.assert_array_equal(pd.data, pj.data)
    x = x0_of(sy.n_free)
    np.testing.assert_array_equal(pt.scatter_vector(x),
                                  pj.scatter_vector(x))
    np.testing.assert_array_equal(pt.gather_vector(pt.scatter_vector(x)), x)


def test_slab_plan_refusals_equal_jax():
    """Slabs thinner than the bandwidth, and a matrix with no DIA form (a
    refined box's numbering), give None in both packages."""
    sy, _dims, A = structured("TETRA4")
    assert J.build_slab_plan(sy.A, 64) is None
    assert T.build_slab_plan(A, 64) is None
    ref = assemble_heat_system(refine_uniform(box_mesh(4, 4, 4, "TETRA4"), 1))
    assert J.build_slab_plan(ref.A, 2) is None
    assert T.build_slab_plan(port_csr(ref), 2) is None
    assert J.build_slab_amg(ref.A, (9, 9, 9), 2) is None
    assert T.build_slab_amg(port_csr(ref), (9, 9, 9), 2, device="cpu") is None


@pytest.mark.parametrize("nparts", PARTS)
@pytest.mark.parametrize("elem", sorted(BOXES))
def test_slab_stencil_equals_jax(elem, nparts):
    sy, dims, A = structured(elem)
    Sj = j_choose(sy.A, dtype=jnp.float32, grid_dims=dims)
    St = choose_operator(A, dtype=torch.float32, grid_dims=dims, device="cpu")
    bj = J.build_slab_stencil(Sj, nparts)
    bt = T.build_slab_stencil(St, nparts)
    assert bt[0] == bj[0]
    np.testing.assert_array_equal(bt[1], bj[1])
    np.testing.assert_array_equal(bt[2], bj[2])
    assert bt[3] == bj[3]
    # Over-partitioned: a slab of fewer than two layers is refused; a
    # period-2 stencil rounds every slab up to two.
    rj, rt = J.build_slab_stencil(Sj, 40), T.build_slab_stencil(St, 40)
    assert (rt is None) == (rj is None) == (elem == "HEX8")


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------


def test_neighbour_strips_are_the_ring_shifts():
    x = torch.arange(12.0).reshape(3, 4)
    left, right = neighbour_strips(x, 2)
    assert left.tolist() == [[0, 0], [2, 3], [6, 7]]
    assert right.tolist() == [[4, 5], [8, 9], [0, 0]]
    one = torch.ones(1, 4)
    assert [s.tolist() for s in neighbour_strips(one, 1)] == [[[0.0]]] * 2


@pytest.mark.parametrize("nparts", PARTS)
@pytest.mark.parametrize("elem", sorted(BOXES))
def test_slab_dia_matvec_equals_jax(elem, nparts):
    sy, dims, A = structured(elem)
    plan = T.build_slab_plan(A, nparts, dtype=np.float64)
    x = plan.scatter_vector(np.random.default_rng(0).normal(size=sy.n_free))
    offsets, halo, slab = plan.offsets, plan.halo, plan.slab
    yj = jax_over_parts(
        lambda d, v: JSlabDIA(data=d, offsets=offsets, halo=halo,
                              slab=slab).matvec(v), plan.data, x)
    op = SlabDIAOperator(data=torch.from_numpy(plan.data), offsets=offsets,
                         halo=halo, slab=slab)
    yt = op.matvec(torch.from_numpy(x)).numpy()
    assert relerr(yt, yj) <= 1e-13
    np.testing.assert_array_equal(yt.reshape(-1)[sy.n_free:], 0.0)
    # The global product: the slab product is A x.
    assert relerr(plan.gather_vector(yt),
                  sy.A.matvec(plan.gather_vector(x))) <= 1e-13


@pytest.mark.parametrize("nparts", PARTS)
@pytest.mark.parametrize("elem", sorted(BOXES))
def test_slab_stencil_matvec_equals_jax(elem, nparts):
    sy, dims, A = structured(elem)
    St = choose_operator(A, dtype=torch.float32, grid_dims=dims, device="cpu")
    _dl, corr, mask, meta = T.build_slab_stencil(St, nparts)
    x = np.zeros(corr.shape)
    x.reshape(-1)[: sy.n_free] = np.random.default_rng(0).normal(
        size=sy.n_free)
    pats = jnp.asarray(St.pats.numpy())
    cvals = jnp.asarray(St.const_vals.numpy())
    yj = jax_over_parts(
        lambda c, m, v: JSlabStencil(pats=pats, const_vals=cvals, corr=c,
                                     mask=m, **meta).matvec(v),
        corr, mask, x)
    op = T.SlabStencilOperator(pats=St.pats, const_vals=St.const_vals,
                               corr=torch.from_numpy(corr),
                               mask=torch.from_numpy(mask), **meta)
    yt = op.matvec(torch.from_numpy(x)).numpy()
    assert relerr(yt, yj) <= 1e-13
    assert relerr(yt.reshape(-1)[: sy.n_free],
                  sy.A.matvec(x.reshape(-1)[: sy.n_free])) <= 1e-13


# ---------------------------------------------------------------------------
# Solves
# ---------------------------------------------------------------------------


def _brick(plan_j, plan_t, dims, route, A):
    if route == "jacobi":
        return {}, {}
    kw = dict(brick=4, dtype=np.float64)
    if route == "brick-global":
        kw.update(global_coarse=True)
        return (dict(brick_precond=J.build_slab_brick_precond(
                    plan_j, dims, A=structured("TETRA4")[0].A, **kw)),
                dict(brick_precond=T.build_slab_brick_precond(
                    plan_t, dims, A=A, **kw)))
    return (dict(brick_precond=J.build_slab_brick_precond(plan_j, dims, **kw)),
            dict(brick_precond=T.build_slab_brick_precond(plan_t, dims, **kw)))


@pytest.mark.parametrize("route", ["jacobi", "brick", "brick-global"])
@pytest.mark.parametrize("nparts", PARTS)
def test_slab_cg_solve_equals_jax(nparts, route):
    sy, dims, A = structured("TETRA4")
    align = dims[0] * dims[1]
    pj = J.build_slab_plan(sy.A, nparts, dtype=np.float64, row_align=align)
    pt = T.build_slab_plan(A, nparts, dtype=np.float64, row_align=align)
    kj, kt = _brick(pj, pt, dims, route, A)
    if kt:
        bj, bt = kj["brick_precond"], kt["brick_precond"]
        for f in ("coarse_inv", "inv_diag", "acc_inv"):
            np.testing.assert_array_equal(getattr(bt, f),
                                          np.asarray(getattr(bj, f)))
        assert bt.use_global == bj.use_global
        assert bt.local_dims == bj.local_dims
    x0 = x0_of(sy.n_free)
    xj, rj = J.slab_cg_solve(pj, sy.b, x0, tol=1e-10, maxiter=2000, **kj)
    xt, rt = T.slab_cg_solve(pt, sy.b, x0, tol=1e-10, maxiter=2000,
                             mesh=mesh_of(nparts), **kt)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    assert relerr(xt, xj) <= 1e-10
    # The port on JAX's exact plan.
    adopted = slab_dia_plan_from_numpy(pj.nparts, pj.n, pj.slab, pj.halo,
                                       pj.offsets, pj.data)
    xa, ra = T.slab_cg_solve(adopted, sy.b, x0, tol=1e-10, maxiter=2000,
                             mesh=mesh_of(nparts), **kt)
    assert ra.iterations == rt.iterations
    np.testing.assert_array_equal(xa, xt)


def test_brick_precond_misaligned_slab_raises_as_jax():
    sy, dims, A = structured("TETRA4")
    pj = J.build_slab_plan(sy.A, 2, dtype=np.float64)  # 8-row aligned only
    pt = T.build_slab_plan(A, 2, dtype=np.float64)
    assert pt.slab % (dims[0] * dims[1]) != 0
    with pytest.raises(ValueError, match="whole number of z-layers"):
        J.build_slab_brick_precond(pj, dims, brick=4)
    with pytest.raises(ValueError, match="whole number of z-layers"):
        T.build_slab_brick_precond(pt, dims, brick=4)


@pytest.mark.parametrize("nparts", PARTS)
def test_slab_stencil_cg_solve_equals_jax(nparts):
    sy, dims, A = structured("TETRA4")
    Sj = j_choose(sy.A, dtype=jnp.float32, grid_dims=dims)
    St = choose_operator(A, dtype=torch.float32, grid_dims=dims, device="cpu")
    b = (sy.b / np.abs(sy.b).max()).astype(np.float32)
    x0 = np.zeros_like(b)
    xj, rj = J.slab_stencil_cg_solve(Sj, nparts, b, x0, tol=1e-6,
                                     maxiter=800)
    xt, rt = T.slab_stencil_cg_solve(St, nparts, b, x0, tol=1e-6,
                                     maxiter=800, mesh=mesh_of(nparts))
    assert rt.converged and xt.dtype == np.float32
    assert abs(rt.iterations - int(rj.iterations)) <= 1
    assert relerr(xt, xj) <= 1e-4


@functools.lru_cache(maxsize=None)
def slab_amgs(dtype, nparts):
    sy, dims, A = structured("TETRA4")
    return (J.build_slab_amg(sy.A, dims, nparts, dtype=dtype),
            T.build_slab_amg(A, dims, nparts, dtype=dtype, device="cpu"))


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32-stencil", "f64-dia"])
@pytest.mark.parametrize("nparts", PARTS)
def test_slab_amg_equals_jax(nparts, dtype):
    sy, dims, A = structured("TETRA4")
    sj, st = slab_amgs(dtype, nparts)
    for f in ("tval", "scale", "inv_diag"):
        got, want = getattr(st, f).cpu().numpy(), np.asarray(getattr(sj, f))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for f in ("lmax", "n_c", "n_pad_c", "slab_c", "dims_local", "brick",
              "smooth_steps"):
        assert getattr(st, f) == getattr(sj, f), f
    np.testing.assert_array_equal(st.plan.data, sj.plan.data)
    # The lattice-stencil fine level in f32, slab DIA in f64, as in JAX.
    stencil = isinstance(st.A, T.SlabStencilOperator)
    assert stencil == (sj.st_meta is not None) == (dtype == np.float32)
    if stencil:
        for k, v in sj.st_meta.items():
            assert getattr(st.A, k) == v, k
        for f, g in (("st_corr", "corr"), ("st_mask", "mask"),
                     ("st_pats", "pats"), ("st_cvals", "const_vals")):
            got = getattr(st.A, g).cpu().numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, getattr(sj, f))
    else:
        np.testing.assert_array_equal(st.A.data.cpu().numpy(), sj.plan.data)
    x0 = x0_of(sy.n_free).astype(dtype)
    b = sy.b.astype(dtype)
    tol = 1e-10 if dtype == np.float64 else 1e-6
    xj, rj = J.slab_amg_cg_solve(sj, b, x0, tol=tol)
    xt, rt = T.slab_amg_cg_solve(st, b, x0, tol=tol)
    assert rt.converged and bool(rj.converged)
    if dtype == np.float64:
        assert rt.iterations == int(rj.iterations)
        assert relerr(xt, xj) <= 1e-10
    else:
        assert abs(rt.iterations - int(rj.iterations)) <= 1
        assert relerr(xt, xj) <= 1e-4


@pytest.mark.parametrize("nparts", PARTS)
def test_slab_amg_iterations_equal_single_device(nparts):
    """P-independence: the slab AMG takes the single-device brick AMG's
    iterations (the port's, f64, the same hierarchy)."""
    sy, dims, A = structured("TETRA4")
    _sj, st = slab_amgs(np.float64, nparts)
    x0 = x0_of(sy.n_free)
    _x, rt = T.slab_amg_cg_solve(st, sy.b, x0, tol=1e-10)
    op = choose_operator(A, dtype=torch.float64, grid_dims=dims, device="cpu")
    M = smoothed_aggregation_setup(A, dtype=torch.float64, grid_dims=dims,
                                   device="cpu")
    b = op.put_vector(sy.b, dtype=torch.float64)
    r1 = cg_solve(op, b, op.put_vector(x0, dtype=torch.float64), precond=M,
                  tol=1e-10, maxiter=300)
    assert rt.iterations == r1.iterations
    assert relerr(rt.x.numpy().reshape(-1)[: sy.n_free],
                  op.get_vector(r1.x)) <= 1e-10
