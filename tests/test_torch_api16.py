"""The rest of the port's single-device API against the JAX package: the
padded layout, the ELL product and its byte count, the precision cast, the
stencil from DIA, RCM, SA-AMG from an ELL operator, and the BSG value
storages (int8, bfloat16, float32) that ``storage="auto"`` picks.

Tolerances: host structures and storage names equal; products 1e-6
relative in f32 and 1e-12 in f64 (the same stored coefficients times the
same inputs, summed in another order); an exact narrow storage (int8 or
bfloat16 holding every value) gives the float32 storage's product and
solve bit for bit, as the kernels convert each value before its product;
fused-CG iterations within two of JAX's (summation order moves the
stopping iteration, as in ``test_torch_fused_cg.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from domain_decomposed_pde_solver_tpu.io import box_mesh as j_box_mesh
from domain_decomposed_pde_solver_tpu.models import (
    assemble_heat_system as j_assemble,
)
from domain_decomposed_pde_solver_tpu.ops import dia as j_dia
from domain_decomposed_pde_solver_tpu.ops import ell as j_ell
from domain_decomposed_pde_solver_tpu.ops import (
    rcm_permute as j_rcm_permute,
    spmv_bytes as j_spmv_bytes,
    ell_spmv as j_ell_spmv,
    stencil_from_dia as j_stencil_from_dia,
)
from domain_decomposed_pde_solver_tpu.ops.bsg import bsg_from_coo as j_bsg_from_coo
from domain_decomposed_pde_solver_tpu.ops.bsg import bsg_from_csr as j_bsg_from_csr
from domain_decomposed_pde_solver_tpu.ops.bsg import bsg_spmv as j_bsg_spmv
from domain_decomposed_pde_solver_tpu.ops.csr import CSRMatrix as JCSR
from domain_decomposed_pde_solver_tpu.solvers.fused_cg import (
    fused_cg_solve as j_fused_cg_solve,
)
from domain_decomposed_pde_solver_tpu.solvers.precond import (
    CastPreconditioner as JCast,
    jacobi_preconditioner as j_jacobi,
    smoothed_aggregation_preconditioner as j_sa_from_ell,
    smoothed_aggregation_setup as j_sa_setup,
)
from domain_decomposed_pde_solver_tpu_torch.ops import (
    dia_from_csr,
    ell_from_csr,
    ell_spmv,
    rcm_permute,
    spmv_bytes,
    stencil_from_dia,
)
from domain_decomposed_pde_solver_tpu_torch.ops.bsg import (
    _rcm_perm,
    bsg_from_coo,
    bsg_from_csr,
    spmv_plain,
)
from domain_decomposed_pde_solver_tpu_torch.ops.dia import DIAMatrix
from domain_decomposed_pde_solver_tpu_torch.ops.ell import ELLMatrix, PaddedLayout
from domain_decomposed_pde_solver_tpu_torch.ops.reorder import rcm_order
from domain_decomposed_pde_solver_tpu_torch.ops.stencil import StencilOperator
from domain_decomposed_pde_solver_tpu_torch.ops._kernels import (
    cluster_smem_bytes,
)
from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
    fused_cg_plan,
    fused_cg_solve,
)
from domain_decomposed_pde_solver_tpu_torch.solvers.precond import (
    CastPreconditioner,
    jacobi_preconditioner,
    smoothed_aggregation_preconditioner,
    smoothed_aggregation_setup,
)
from domain_decomposed_pde_solver_tpu_torch.utils.convert import (
    csr_from_numpy,
    operator_from_csr,
)
from torch_parity import (
    MESH_DIMS,
    jax_problem,
    mesh_id,
    port_csr,
    rand,
    random_laplacian,
    relerr,
)

torch.set_num_threads(1)

TOL = {"float32": 1e-6, "float64": 1e-12}
DTYPES = [("float32", torch.float32, jnp.float32),
          ("float64", torch.float64, jnp.float64)]


def _box(shape=(16, 10, 12), elem="TETRA4"):
    sy = j_assemble(j_box_mesh(*shape, elem_type=elem))
    return sy, port_csr(sy), (shape[0] - 1, shape[1] + 1, shape[2] + 1)


# -- PaddedLayout, ell_spmv, spmv_bytes ---------------------------------------


def test_identity_layout_operators_share_padded_layout():
    sy, csr, dims = _box()
    for cls in (ELLMatrix, DIAMatrix, StencilOperator):
        assert issubclass(cls, PaddedLayout)
        assert "put_vector" not in vars(cls) and "get_vector" not in vars(cls)
    Dj = j_dia.dia_from_csr(sy.A, dtype=jnp.float64)
    Dp = dia_from_csr(csr, dtype=torch.float64, device="cpu")
    x = rand(sy.A.n_rows, seed=1)
    xp, xj = Dp.put_vector(x), Dj.put_vector(x)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(Dp.get_vector(xp), np.asarray(
        Dj.get_vector(xj)))
    assert Dp.put_vector(x, dtype=torch.float32).dtype == torch.float32


@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("dims", MESH_DIMS, ids=mesh_id)
def test_ell_spmv_and_bytes_match_jax(dims, name, tdt, jdt):
    _mesh, sy = jax_problem(dims)
    Aj = j_ell.ell_from_csr(sy.A, dtype=jdt)
    Ap = ell_from_csr(port_csr(sy), dtype=tdt, device="cpu")
    x = rand(sy.A.n_rows, seed=2).astype(name)
    yj = np.asarray(j_ell_spmv(Aj, Aj.put_vector(x)))
    yp = ell_spmv(Ap, Ap.put_vector(x)).numpy()
    assert yp.dtype == np.dtype(name)
    assert relerr(yp, yj) <= TOL[name]
    np.testing.assert_array_equal(Ap.matvec(Ap.put_vector(x)).numpy(), yp)
    assert spmv_bytes(Ap) == j_spmv_bytes(Aj)
    assert spmv_bytes(Ap, dtype_bytes=2) == j_spmv_bytes(Aj, dtype_bytes=2)


# -- CastPreconditioner -------------------------------------------------------


def test_cast_preconditioner_matches_jax():
    _mesh, sy = jax_problem(MESH_DIMS[0])
    Aj = j_ell.ell_from_csr(sy.A, dtype=jnp.float32)
    Ap = ell_from_csr(port_csr(sy), dtype=torch.float32, device="cpu")
    Mj = JCast(inner=j_jacobi(Aj), dtype=jnp.float32)
    Mp = CastPreconditioner(inner=jacobi_preconditioner(Ap),
                            dtype=torch.float32)
    r = rand(Ap.n_pad, seed=3)
    zj = np.asarray(Mj(jnp.asarray(r)))
    zp = Mp(torch.as_tensor(r))
    assert zp.dtype == torch.float64 and zj.dtype == np.float64
    # One float32 multiply per entry on each side: the same bits.
    np.testing.assert_array_equal(zp.numpy(), zj)
    inner = jacobi_preconditioner(Ap)(torch.as_tensor(r, dtype=torch.float32))
    assert torch.equal(zp, inner.double())


# -- stencil_from_dia ---------------------------------------------------------


@pytest.mark.parametrize("shape,elem", [((16, 10, 12), "TETRA4"),
                                        ((8, 9, 10), "HEX8")])
def test_stencil_from_dia_matches_jax(shape, elem):
    sy, csr, dims = _box(shape, elem)
    Sj = j_stencil_from_dia(j_dia.dia_from_csr(sy.A, dtype=jnp.float32), dims)
    Dp = dia_from_csr(csr, dtype=torch.float32, device="cpu")
    Sp = stencil_from_dia(Dp, dims)
    assert Sp is not None and Sj is not None
    assert Sp.device == Dp.device
    assert (Sp.taps, Sp.groups, Sp.period, Sp.dims) == (
        Sj.taps, Sj.groups, Sj.period, Sj.dims)
    np.testing.assert_array_equal(Sp.pats.numpy(), np.asarray(Sj.pats))
    np.testing.assert_array_equal(Sp.corr.numpy(), np.asarray(Sj.corr))
    x = rand(sy.A.n_rows, seed=4).astype(np.float32)
    yp = Sp.get_vector(Sp.matvec(Sp.put_vector(x)))
    yj = np.asarray(Sj.get_vector(Sj.matvec(Sj.put_vector(x))))
    assert relerr(yp, yj) <= TOL["float32"]
    # A grid that does not fit the matrix gives no stencil in either.
    wrong = (dims[1], dims[0], dims[2])
    assert stencil_from_dia(Dp, wrong) is None
    assert j_stencil_from_dia(j_dia.dia_from_csr(sy.A, dtype=jnp.float32),
                              wrong) is None


# -- RCM ------------------------------------------------------------------------


@pytest.mark.parametrize("dims", MESH_DIMS, ids=mesh_id)
def test_rcm_permute_matches_jax(dims):
    _mesh, sy = jax_problem(dims)
    Pp, perm_p = rcm_permute(port_csr(sy))
    Pj, perm_j = j_rcm_permute(sy.A)
    assert perm_p is not None
    np.testing.assert_array_equal(perm_p, perm_j)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(Pp, f), np.asarray(getattr(Pj, f)))
    assert Pp.shape == Pj.shape
    x = rand(sy.A.n_rows, seed=5)
    # P A P^T applied to x[perm] is (A x)[perm].
    np.testing.assert_allclose(Pp.matvec(x[perm_p]), sy.A.matvec(x)[perm_p],
                               rtol=1e-13, atol=1e-12)


def test_rcm_permute_without_the_native_library(monkeypatch):
    from domain_decomposed_pde_solver_tpu_torch.utils import native

    monkeypatch.setattr(native, "rcm_order_native", lambda *a: None)
    csr = port_csr(jax_problem(MESH_DIMS[1])[1])
    out, perm = rcm_permute(csr)
    assert out is csr and perm is None


@pytest.mark.parametrize("dims", MESH_DIMS, ids=mesh_id)
def test_bsg_rcm_is_scipys_as_in_jax(dims):
    """The sliced-ELL packer numbers rows by scipy's RCM, as JAX's BSG
    packer does; ``rcm_permute`` by the native one, as JAX's does (the two
    break ties differently and can give different orders)."""
    _mesh, sy = jax_problem(dims)
    csr = port_csr(sy)
    perm = _rcm_perm(csr)
    np.testing.assert_array_equal(perm, np.asarray(j_bsg_from_csr(sy.A).perm))
    order = rcm_order(csr, native=False)
    np.testing.assert_array_equal(perm[order], np.arange(csr.n_rows))


def test_native_and_scipy_rcm_orders_differ_as_in_jax():
    """On a refined 5^3 box the two RCM codes give different orders, in
    the port as in JAX: each package keeps both, where JAX uses each."""
    from domain_decomposed_pde_solver_tpu.io import refine_uniform as j_refine

    sy = j_assemble(j_refine(j_box_mesh(5, 5, 5, elem_type="TETRA4"), 1))
    csr = port_csr(sy)
    native, scipys = rcm_order(csr), rcm_order(csr, native=False)
    assert not np.array_equal(native, scipys)
    np.testing.assert_array_equal(native, j_rcm_permute(sy.A)[1])
    perm = np.empty_like(scipys)
    perm[scipys] = np.arange(scipys.size)
    np.testing.assert_array_equal(perm, np.asarray(j_bsg_from_csr(sy.A).perm))


# -- SA-AMG from an ELL operator -------------------------------------------------


@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=[d[0] for d in DTYPES])
def test_smoothed_aggregation_preconditioner_matches_jax(name, tdt, jdt):
    _mesh, sy = jax_problem(MESH_DIMS[0])
    Aj = j_ell.ell_from_csr(sy.A, dtype=jdt)
    Ap = ell_from_csr(port_csr(sy), dtype=tdt, device="cpu")
    Mj = j_sa_from_ell(Aj)
    Mp = smoothed_aggregation_preconditioner(Ap)
    assert [l.n_rows for l in Mp.levels] == [l.n_rows for l in Mj.levels]
    assert len(Mp.levels) >= 2
    for lp, lj in zip(Mp.levels, Mj.levels):
        assert float(lp.lmax) == pytest.approx(float(lj.lmax), rel=1e-6)
        assert lp.lmax.dtype == tdt
    # The CSR route gives the same hierarchy as the ELL route.
    Mc = smoothed_aggregation_setup(port_csr(sy), dtype=tdt, device="cpu")
    assert [l.n_rows for l in Mc.levels] == [l.n_rows for l in Mp.levels]
    r = rand(Ap.n_pad, seed=6).astype(name)
    r[sy.A.n_rows:] = 0
    zj = np.asarray(Mj(jnp.asarray(r)))[: sy.A.n_rows]
    zp = Mp(torch.as_tensor(r)).numpy()[: sy.A.n_rows]
    zc = Mc(torch.as_tensor(r)).numpy()[: sy.A.n_rows]
    tol = 1e-5 if name == "float32" else 1e-12
    assert relerr(zp, zj) <= tol
    np.testing.assert_array_equal(zp, zc)


# -- BSG value storage ----------------------------------------------------------


def _general_matrix(n=900, seed=7):
    """SPD with values that fit neither int8 nor bfloat16."""
    L = random_laplacian(n, 8, seed, shift=0.5)
    rng = np.random.default_rng(seed)
    L.data = L.data * (1.0 + 0.01 * rng.random(L.data.size))
    L = ((L + L.T) * 0.5).tocsr()
    L.sort_indices()
    return L


def _matrices():
    _mesh, sy = jax_problem(MESH_DIMS[1])
    S = sp.csr_matrix((sy.A.data, sy.A.indices, sy.A.indptr),
                      shape=sy.A.shape)
    return {
        "laplacian": (S, "int8"),  # degrees and -1s
        "bf16_exact": (random_laplacian(900, 8, 1, shift=0.5), "bfloat16"),
        "general": (_general_matrix(), "float32"),
    }


def _pair(S, storage="auto", layout="auto"):
    j = JCSR(indptr=S.indptr.astype(np.int64),
             indices=S.indices.astype(np.int64),
             data=S.data.astype(np.float64), shape=S.shape)
    p = csr_from_numpy(S.indptr, S.indices, S.data, S.shape)
    return j_bsg_from_csr(j, storage=storage), bsg_from_csr(
        p, storage=storage, layout=layout, device="cpu")


@pytest.mark.parametrize("kind", ["laplacian", "bf16_exact", "general"])
def test_auto_storage_matches_jax(kind):
    S, want = _matrices()[kind]
    Aj, Ap = _pair(S)
    assert Ap.storage == Aj.storage == want
    assert Ap.vals.dtype == {"int8": torch.int8, "bfloat16": torch.bfloat16,
                             "float32": torch.float32}[want]
    assert Ap.dtype == torch.float32  # its vectors
    # The rectangular packer takes the same rule.
    coo = S.tocoo()
    Cj = j_bsg_from_coo(coo.row, coo.col, coo.data, S.shape[0], S.shape[1])
    Cp = bsg_from_coo(coo.row, coo.col, coo.data, S.shape[0], S.shape[1],
                      device="cpu")
    assert Cp.storage == Cj.storage == want
    # And the adopting converter takes JAX's string as it is.
    p = csr_from_numpy(S.indptr, S.indices, S.data, S.shape)
    assert operator_from_csr(p, perm=np.asarray(Aj.perm),
                             storage=Aj.storage, device="cpu").storage == want


@pytest.mark.parametrize("kind", ["laplacian", "bf16_exact", "general"])
def test_plain_product_per_storage_matches_jax_kernel(kind):
    S, want = _matrices()[kind]
    Aj, Ap = _pair(S)
    x = rand(S.shape[0], seed=8, dtype=np.float32)
    yj = Aj.get_vector(j_bsg_spmv(Aj, Aj.put_vector(x), interpret=True))
    yp = Ap.get_vector(spmv_plain(Ap, Ap.put_vector(x)))
    assert relerr(yp, yj) <= TOL["float32"]
    # Every storage that holds these values exactly gives the same bits
    # (the values convert exactly before their products), in f32 and f64.
    exact = {"int8": ("int8", "bfloat16", "float32"),
             "bfloat16": ("bfloat16", "float32"),
             "float32": ("float32",)}[want]
    for dt in (torch.float32, torch.float64):
        ys = [spmv_plain(_pair(S, storage=s)[1],
                         Ap.put_vector(x, dtype=dt)) for s in exact]
        for y in ys[1:]:
            assert torch.equal(y, ys[0])
    # Ragged layout: the same slots, storage and plain product.
    R = _pair(S, layout="ragged")[1]
    assert R.storage == want
    assert relerr(R.get_vector(spmv_plain(R, R.put_vector(x))), yp) <= 1e-6


def test_forced_storages_cast_as_jax_does():
    S, _ = _matrices()["bf16_exact"]
    for storage in ("int8", "bfloat16", "float32"):
        Aj, Ap = _pair(S, storage=storage)
        assert Ap.storage == Aj.storage == storage
        assert Ap.dtype == torch.float32
    # float64 is the port's own storage (f64 operators; JAX's BSG has none).
    p = csr_from_numpy(S.indptr, S.indices, S.data, S.shape)
    A64 = bsg_from_csr(p, storage="float64", device="cpu")
    assert A64.storage == "float64" and A64.dtype == torch.float64
    Aj, Ap = _pair(S, storage="int8")  # lossy, as JAX casts
    assert Aj.storage == "int8"
    x = rand(S.shape[0], seed=9, dtype=np.float32)
    yj = Aj.get_vector(Aj.matvec_reference(Aj.put_vector(x)))
    yp = Ap.get_vector(spmv_plain(Ap, Ap.put_vector(x)))
    assert relerr(yp, yj) <= TOL["float32"]
    with pytest.raises(ValueError):
        bsg_from_csr(p, storage="float16", device="cpu")


def test_amg_chain_levels_take_the_storage_rule():
    """AMG levels packed as sliced ELL take ``storage="auto"`` level by
    level, as in JAX (the fine graph Laplacian int8, the Galerkin levels
    float32); G and GT stay float32 as JAX packs them."""
    _mesh, sy = jax_problem(MESH_DIMS[0])
    kw = dict(bsg_level_min_rows=100, bsg_transfer_min_rows=1000)
    Aj = j_bsg_from_csr(sy.A)
    Ap = bsg_from_csr(port_csr(sy), device="cpu")
    Mj = j_sa_setup(sy.A, dtype=jnp.float32, fine_operator=Aj, **kw)
    Mp = smoothed_aggregation_setup(port_csr(sy), dtype=torch.float32,
                                    fine_operator=Ap, device="cpu", **kw)
    sj = [getattr(l.A, "storage", None) for l in Mj.levels]
    spo = [getattr(l.A, "storage", None) for l in Mp.levels]
    assert spo == sj and spo[0] == "int8"
    assert any(s == "float32" for s in spo[1:])
    P0 = Mp.levels[0].P
    assert P0.G.storage == P0.GT.storage == "float32"
    r = rand(Ap.n_pad, seed=10, dtype=np.float32)
    zj = np.asarray(Mj(Aj.put_vector(Aj.get_vector(jnp.asarray(r)))))
    zp = Mp(Ap.put_vector(Ap.get_vector(torch.as_tensor(r)))).numpy()
    assert relerr(Ap.get_vector(torch.as_tensor(zp)),
                  np.asarray(Aj.get_vector(jnp.asarray(zj)))) <= 1e-5


@pytest.mark.parametrize("dims", MESH_DIMS, ids=mesh_id)
def test_fused_cg_plain_on_int8_storage_matches_jax(dims):
    _mesh, sy = jax_problem(dims)
    Aj = j_bsg_from_csr(sy.A)
    Ap = bsg_from_csr(port_csr(sy), device="cpu")
    F = bsg_from_csr(port_csr(sy), storage="float32", device="cpu")
    assert Aj.storage == Ap.storage == "int8"
    b = (sy.b / np.abs(sy.b).max()).astype(np.float32)
    rj = j_fused_cg_solve(Aj, Aj.put_vector(b), tol=1e-6, maxiter=500)
    rp = fused_cg_solve(Ap, Ap.put_vector(b), tol=1e-6, maxiter=500)
    rf = fused_cg_solve(F, F.put_vector(b), tol=1e-6, maxiter=500)
    assert rp.converged and bool(rj.converged)
    assert abs(rp.iterations - int(rj.iterations)) <= 2
    assert rp.iterations == rf.iterations and torch.equal(rp.x, rf.x)


def test_fused_instance_rule_ignores_narrow_values():
    """The cluster instance's admission counts float32 values whatever the
    storage, so an int8 operator takes the instance its float32 copy
    takes; its launch needs fewer shared-memory bytes."""
    _mesh, sy = jax_problem(MESH_DIMS[1])
    Ap = bsg_from_csr(port_csr(sy), device="cpu")
    F = bsg_from_csr(port_csr(sy), storage="float32", device="cpu")
    pi, pf = fused_cg_plan(Ap), fused_cg_plan(F)
    assert pi.instance == pf.instance == "cluster"
    assert (pi.pack.max_slots, pi.pack.max_win) == (pf.pack.max_slots,
                                                    pf.pack.max_win)
    ms, mw = pf.pack.max_slots, pf.pack.max_win
    assert cluster_smem_bytes(ms, mw, 1) + 3 * ms == cluster_smem_bytes(ms, mw)
    assert cluster_smem_bytes(ms, mw, 2) + 2 * ms == cluster_smem_bytes(ms, mw)
