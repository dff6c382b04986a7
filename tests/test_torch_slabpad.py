"""The port's slab pad-stencil engine against the JAX package:
``build_slab_pad_stencil`` (L, the windows' z-bounds, the window
corrections, the inverse diagonal), the slab product (kernel 3's plain
version on every part's window in the port, the Pallas kernel in
interpret mode in JAX), its f64 form against JAX's masked
``stencil_core`` residual, and ``slab_pad_cg_solve``.

JAX runs each part on one of the 8 virtual CPU devices that
``tests/conftest.py`` forces; the port drives every part on the CPU.  Both
split pad-stencil operators built from the same host stencil
decomposition at bz = 4 (``tests/test_slabpad.py``'s sizes), so their
padded spaces are the same: free grids (9, 15, 8) at P = 2 (slabs of 6
and 2 real layers) and (9, 9, 19) at P = 4 (6, 6, 6, 1), TETRA4 and HEX8.

Tolerances: plans equal bit for bit (the correction in bfloat16 in both);
the f32 product within 1e-6 relative of JAX's (the same f32 products in
another order) with every pad slot and dead layer exactly 0; the f64
product within 1e-13; Jacobi-CG in f32 within one iteration of JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import domain_decomposed_pde_solver_tpu.parallel as J
from domain_decomposed_pde_solver_tpu.io import box_mesh
from domain_decomposed_pde_solver_tpu.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu.ops.dia import pack_dia_host
from domain_decomposed_pde_solver_tpu.ops.pallas.stencil_kernel import (
    pad_stencil_from_parts as j_pad_stencil,
)
from domain_decomposed_pde_solver_tpu.ops.stencil import (
    stencil_parts_from_packed,
)
from domain_decomposed_pde_solver_tpu.parallel.sharded import AXIS
from domain_decomposed_pde_solver_tpu.parallel.slabpadmixed import (
    _slab_matvec_f64,
)
from domain_decomposed_pde_solver_tpu.solvers.precond.amg import (
    infer_free_grid,
)
import domain_decomposed_pde_solver_tpu_torch.parallel as T
from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
    pad_window_reference,
)
from domain_decomposed_pde_solver_tpu_torch.parallel.slabpad import (
    slab_layers,
)
from domain_decomposed_pde_solver_tpu_torch.utils.convert import (
    pad_stencil_from_parts,
    slab_pad_plan_from_numpy,
)
from torch_parity import relerr

torch.set_num_threads(1)

# (box cells, parts): free grids (9, 15, 8) and (9, 9, 19).
CASES = {"P2": ((10, 14, 7), 2), "P4": ((10, 8, 18), 4)}
ELEMS = ["TETRA4", "HEX8"]


@functools.lru_cache(maxsize=None)
def pad_pair(shape, elem, bz=4):
    """(JAX system, free grid, JAX pad operator, the port's) built from
    one host stencil decomposition."""
    mesh = box_mesh(*shape, elem_type=elem)
    sy = assemble_heat_system(mesh)
    dims = infer_free_grid(mesh, sy.free_to_node)
    offs, data = pack_dia_host(sy.A, dtype=jnp.float32)
    parts = stencil_parts_from_packed(offs, data, sy.A.n_rows, dims)
    return (sy, dims, j_pad_stencil(parts, bz=bz),
            pad_stencil_from_parts(parts, bz=bz, device="cpu"))


@functools.lru_cache(maxsize=None)
def plans(case, elem):
    shape, P_ = CASES[case]
    sy, dims, Aj, At = pad_pair(shape, elem)
    return sy, Aj, At, J.build_slab_pad_stencil(Aj, P_), \
        T.build_slab_pad_stencil(At, P_)


def jax_slab_product(pj, x_stacked, patterns=None):
    """JAX's per-device slab product of ``(P, slab)`` vectors: the Pallas
    kernel in interpret mode, or with ``patterns`` (the operator's
    ``pats``, ``const_vals``) the f64 ``stencil_core`` residual."""
    dev_mesh = J.make_device_mesh(pj.nparts)
    sh = NamedSharding(dev_mesh, JP(AXIS))
    ops = jax.tree.map(lambda a: jax.device_put(a, sh),
                       pj.make_ops(interpret=True))

    def body(op_blk, x_blk):
        op = jax.tree.map(lambda a: a[0], op_blk)
        if patterns is not None:
            return _slab_matvec_f64(op, *patterns, x_blk[0])[None]
        return op.matvec(x_blk[0])[None]

    return np.asarray(jax.shard_map(
        body, mesh=dev_mesh, in_specs=(JP(AXIS), JP(AXIS)),
        out_specs=JP(AXIS), check_vma=False)(
            ops, jax.device_put(jnp.asarray(x_stacked), sh)))


@pytest.mark.parametrize("elem", ELEMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_slab_pad_plan_equals_jax(case, elem):
    _sy, Aj, At, pj, pt = plans(case, elem)
    for f in ("nparts", "L", "dims", "myp", "mxp", "bz"):
        assert getattr(pt, f) == getattr(pj, f), f
    np.testing.assert_array_equal(pt.zlims, pj.zlims)
    np.testing.assert_array_equal(pt.quads, pj.quads)
    assert str(np.asarray(pj.corr_ext).dtype) == "bfloat16"
    assert pt.corr_ext.dtype == torch.bfloat16
    assert tuple(pt.corr_ext.shape) == pj.corr_ext.shape
    np.testing.assert_array_equal(
        pt.corr_ext.float().numpy(),
        np.asarray(pj.corr_ext).astype(np.float32))
    np.testing.assert_array_equal(pt.inv_diag.numpy(), pj.inv_diag)
    for k in ("taps", "groups", "group_const", "period"):
        assert pt.meta[k] == pj.meta[k], k
    x = np.random.default_rng(0).normal(size=int(np.prod(pt.dims)))
    np.testing.assert_array_equal(pt.scatter_vector(x), pj.scatter_vector(x))
    np.testing.assert_array_equal(pt.gather_vector(pt.scatter_vector(x)),
                                  pj.gather_vector(pj.scatter_vector(x)))


@pytest.mark.parametrize("bz,z_align,mz,nparts", [
    (4, 1, 19, 4), (4, 1, 19, 8), (4, 6, 19, 2), (6, 6, 30, 2),
    (8, 6, 31, 2), (8, 6, 31, 4), (6, 4, 30, 3)])
def test_slab_layers_follow_jax(bz, z_align, mz, nparts):
    """The L rule, its None for an unsolvable congruence (gcd(bz, z_align)
    > 2) and for a trailing slab with no layer; against JAX's plan on a
    pad operator of that depth (a HEX8 box, free grid 9 x 9 x mz)."""
    L = slab_layers(mz, nparts, bz, z_align)
    if L is not None:
        assert L % 2 == 0 and (L + 2) % bz == 0 and L % z_align == 0
        assert L >= 2 * bz - 2 and (nparts - 1) * L < mz
    _sy, dims, Aj, At = pad_pair((10, 8, mz - 1), "HEX8", bz=bz)
    assert dims[2] == mz and Aj.bz == At.bz == bz
    pj = J.build_slab_pad_stencil(Aj, nparts, z_align=z_align)
    pt = T.build_slab_pad_stencil(At, nparts, z_align=z_align)
    assert (pj is None) == (pt is None) == (L is None)
    if pj is not None:
        assert pj.L == pt.L == L


def test_slab_pad_refusals_equal_jax():
    """Too many parts (a trailing slab would own no layer) and an
    unsolvable rule (bz = 6 with z_align = 6) give None in both."""
    _sy, _dims, Aj, At = pad_pair((10, 8, 18), "TETRA4")
    assert J.build_slab_pad_stencil(Aj, 8) is None
    assert T.build_slab_pad_stencil(At, 8) is None
    _sy, _dims, Aj6, At6 = pad_pair((10, 8, 18), "TETRA4", bz=6)
    assert J.build_slab_pad_stencil(Aj6, 2, z_align=6) is None
    assert T.build_slab_pad_stencil(At6, 2, z_align=6) is None


@pytest.mark.parametrize("elem", ELEMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_slab_pad_matvec_equals_jax(case, elem):
    sy, Aj, At, pj, pt = plans(case, elem)
    x = np.random.default_rng(0).standard_normal(sy.n_free).astype(
        np.float32)
    xs = pt.scatter_vector(x)
    yj = jax_slab_product(pj, xs)
    yt = pt.make_ops().matvec(torch.from_numpy(xs)).numpy()
    assert relerr(yt, yj) <= 1e-6
    # Every pad slot and dead layer exactly 0, as in JAX.
    live = pt.scatter_vector(np.ones(sy.n_free, np.float32)) != 0
    np.testing.assert_array_equal(yt[~live], 0.0)
    np.testing.assert_array_equal(yj[~live], 0.0)
    # The slab product is the single-device pad product.
    y1 = At.get_vector(At.matvec(At.put_vector(x)))
    assert relerr(pt.gather_vector(yt), y1) <= 1e-6


@pytest.mark.parametrize("elem", ELEMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_slab_pad_f64_product_equals_jax_masked_core(case, elem):
    """The f64 residual's product: the port's plain window version in
    double against JAX's ``stencil_core`` evaluation with the dead layers
    masked (``slabpadmixed.py:71-86`` there)."""
    sy, Aj, At, pj, pt = plans(case, elem)
    x = np.random.default_rng(3).standard_normal(sy.n_free)
    xs = pt.scatter_vector(x, dtype=np.float64)
    yj = jax_slab_product(pj, xs, patterns=(
        np.asarray(Aj.pats, np.float32), np.asarray(Aj.const_vals,
                                                    np.float32)))
    op = pt.make_ops()
    yt = op.matvec(torch.from_numpy(xs)).numpy()
    assert yt.dtype == np.float64
    assert relerr(yt, yj) <= 1e-13
    assert relerr(pt.gather_vector(yt), sy.A.matvec(x)) <= 1e-13
    # Part by part, the window version on its own.
    xe = op.extended(torch.from_numpy(xs))
    layer = op.myp * op.mxp
    for p in range(op.nparts):
        yw = pad_window_reference(op, xe[p], op.corr_ext[p], op.zlim[p])
        np.testing.assert_array_equal(
            yw.numpy()[layer: (op.L + 1) * layer], yt[p])


@pytest.mark.parametrize("case", sorted(CASES))
def test_slab_pad_cg_solve_equals_jax(case):
    sy, Aj, At, pj, pt = plans(case, "TETRA4")
    b = sy.b
    x0 = np.zeros(sy.n_free)
    xj, rj = J.slab_pad_cg_solve(pj, b, x0, tol=1e-6, maxiter=500)
    xt, rt = T.slab_pad_cg_solve(pt, b, x0, tol=1e-6, maxiter=500)
    assert rt.converged and bool(rj.converged)
    assert abs(rt.iterations - int(rj.iterations)) <= 1
    assert relerr(xt, xj) <= 1e-4
    # The port on JAX's exact plan takes the same iterations.
    adopted = slab_pad_plan_from_numpy(
        pj.nparts, pj.L, pj.dims, pj.myp, pj.mxp, pj.bz, pj.quads, pj.zlims,
        np.asarray(pj.corr_ext).astype(np.float32), pj.inv_diag, pj.meta,
        np.asarray(Aj.pats), np.asarray(Aj.const_vals),
        corr_storage="bfloat16", device="cpu")
    xa, ra = T.slab_pad_cg_solve(adopted, b, x0, tol=1e-6, maxiter=500)
    assert ra.iterations == rt.iterations
    np.testing.assert_array_equal(xa, xt)
