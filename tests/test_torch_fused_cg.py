"""The port's fused Jacobi-PCG (``solvers/fused_cg.py``) against the JAX
package's, on the graphs of ``tests/test_fused_cg.py``.

JAX runs its whole-solve Pallas kernel in interpret mode here (as that
file runs it); the port runs ``fused_cg_solve(device="cpu")``, which is
``fused_cg_plain``, the kernel's recurrence in plain PyTorch.  The CUDA
kernel itself is held to ``fused_cg_plain`` on the card
(``tests/test_torch_cuda.py``).  The cluster instance's host pack and its
plain product (``cluster_spmv_plain``: window gather, 16-bit local
columns) are held here to ``spmv_plain`` (bit for bit: the same products
added in the same order) and to JAX's ``bsg_spmv`` (Pallas, interpret
mode; f32, 1e-6 relative), and the instance rule is a pure function.

Tolerances: both are float32 CG to 1e-6 with the same stopping test on
squared norms; their dots add in different orders, so they stop within 2
iterations of each other (the JAX file's own bound against the unfused
solver), and the answer's host f64 relative residual is < 5e-6.
"""

import gc

import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.ops.bsg import bsg_from_csr as j_bsg_from_csr
from domain_decomposed_pde_solver_tpu.ops.bsg import bsg_spmv as j_bsg_spmv
from domain_decomposed_pde_solver_tpu.ops.csr import CSRMatrix
from domain_decomposed_pde_solver_tpu.solvers.fused_cg import (
    fused_cg_solve as j_fused_cg_solve,
)
from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
from domain_decomposed_pde_solver_tpu_torch.ops.bsg import bsg_from_csr, spmv_plain
from domain_decomposed_pde_solver_tpu_torch.solvers import (
    cg_solve,
    fused_cg_solve,
    jacobi_preconditioner,
)
from domain_decomposed_pde_solver_tpu_torch.solvers import fused_cg as fused_cg_mod
from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
    _inverse_diagonal,
    cluster_pack,
    cluster_spmv_plain,
    fused_cg_instance,
    fused_cg_plan,
)
from domain_decomposed_pde_solver_tpu_torch.utils.convert import csr_from_numpy
from torch_parity import jax_problem, mesh_id, port_csr, rand, random_laplacian, relerr

torch.set_num_threads(1)


def _operators(S):
    j = CSRMatrix(indptr=S.indptr.astype(np.int64),
                  indices=S.indices.astype(np.int64),
                  data=S.data.astype(np.float64), shape=S.shape)
    p = csr_from_numpy(S.indptr, S.indices, S.data, S.shape)
    return j_bsg_from_csr(j), bsg_from_csr(p, device="cpu")


def _host_relres(S, A, x, b_host):
    xh = A.get_vector(x).astype(np.float64)
    return np.linalg.norm(S @ xh - b_host) / np.linalg.norm(b_host)


@pytest.mark.parametrize("n,deg,seed", [(700, 8, 0), (2500, 14, 1)])
def test_fused_cg_matches_jax(n, deg, seed):
    S = random_laplacian(n, deg, seed, shift=0.5)
    Aj, Ap = _operators(S)
    x_true = np.random.default_rng(seed + 7).standard_normal(n)
    b_host = (S @ x_true).astype(np.float32)
    rj = j_fused_cg_solve(Aj, Aj.put_vector(b_host), tol=1e-6, maxiter=500)
    bp = Ap.put_vector(b_host)
    before = _kernels.FUSED_CG.launches
    rp = fused_cg_solve(Ap, bp, tol=1e-6, maxiter=500)
    assert _kernels.FUSED_CG.launches == before  # CPU: the plain version
    assert rp.converged and bool(rj.converged)
    assert rp.x.dtype == torch.float32 and rp.x.shape == (Ap.n_pad,)
    assert abs(rp.iterations - int(rj.iterations)) <= 2
    assert _host_relres(S, Ap, rp.x, b_host) < 5e-6
    assert abs(rp.relres - float(rj.relres)) <= 0.5 * float(rj.relres)
    # The unfused solver with the Jacobi preconditioner: the same solve.
    ref = cg_solve(Ap, bp, torch.zeros_like(bp),
                   precond=jacobi_preconditioner(Ap), tol=1e-6, maxiter=500)
    assert abs(rp.iterations - ref.iterations) <= 2


def test_fused_cg_respects_maxiter():
    S = random_laplacian(500, 8, 3, shift=1e-3)  # ill-conditioned
    Aj, Ap = _operators(S)
    b = np.random.default_rng(4).standard_normal(500).astype(np.float32)
    rj = j_fused_cg_solve(Aj, Aj.put_vector(b), tol=1e-12, maxiter=7)
    rp = fused_cg_solve(Ap, Ap.put_vector(b), tol=1e-12, maxiter=7)
    assert rp.iterations == int(rj.iterations) == 7
    assert not rp.converged and not bool(rj.converged)


def test_fused_cg_warm_start_and_zero_rhs():
    S = random_laplacian(600, 9, 5, shift=0.5)
    _Aj, A = _operators(S)
    x_true = np.random.default_rng(6).standard_normal(600)
    b = A.put_vector((S @ x_true).astype(np.float32))
    r1 = fused_cg_solve(A, b, tol=1e-6, maxiter=500)
    r2 = fused_cg_solve(A, b, x0=r1.x, tol=1e-6, maxiter=500)
    assert r1.converged and r2.iterations == 0 and r2.converged
    zero = fused_cg_solve(A, torch.zeros_like(b), tol=1e-6)
    assert zero.iterations == 0 and zero.converged and zero.relres == 0.0


def test_fused_cg_inverse_diagonal_is_jax_rule():
    """``invd = where(d != 0, 1/d, 0)`` (JAX ``fused_cg.py:179-180``), not
    the Jacobi preconditioner's fill of 1 on a zero diagonal."""
    S = random_laplacian(300, 6, 8, shift=0.5).tolil()
    S[5, 5] = 0.0  # one zero diagonal entry
    S = S.tocsr()
    _Aj, A = _operators(S)
    invd = _inverse_diagonal(A)
    d = A.diag.numpy()
    assert (d == 0).sum() > 0
    np.testing.assert_array_equal(invd.numpy(),
                                  np.where(d != 0, 1.0 / np.where(d == 0, 1, d),
                                           0.0).astype(np.float32))
    assert float(jacobi_preconditioner(A).inv_diag[d == 0].min()) == 1.0


def test_fused_cg_refuses_ragged_and_f64_operators():
    S = random_laplacian(400, 6, 9, shift=0.5)
    p = csr_from_numpy(S.indptr, S.indices, S.data, S.shape)
    R = bsg_from_csr(p, layout="ragged", device="cpu")
    b = torch.ones(R.n_pad)
    with pytest.raises(ValueError, match="dense"):
        fused_cg_solve(R, b)
    D64 = bsg_from_csr(p, storage="float64", device="cpu")
    with pytest.raises(ValueError, match="float32"):
        fused_cg_solve(D64, b)


# Refined TETRA4 boxes: 5^3 -> 964 DOF (n_pad 1,024, a cluster of one CTA),
# 8^3 -> 3,823 (4,096), 10^3 -> 7,379 (8,192): the 16,028-DOF operator's
# family at smaller depth.
PACK_DIMS = [(5, 5, 5), (8, 8, 8), (10, 10, 10)]


@pytest.mark.parametrize("dims", PACK_DIMS, ids=mesh_id)
def test_cluster_pack_windows_cover_every_column(dims):
    _mesh, sy = jax_problem(dims)
    A = bsg_from_csr(port_csr(sy), device="cpu")
    pk = cluster_pack(A)
    assert pk.ctas == A.n_pad // 1024
    lo_w = pk.windows.view(-1, 2).numpy()
    sp, cols = A.slice_ptr.numpy(), A.cols.numpy()
    vals, lcols = A.vals.numpy(), pk.lcols.numpy().view(np.uint16)
    bounds = sp[np.arange(pk.ctas + 1) * 32]
    assert pk.max_slots == np.diff(bounds).max() and pk.max_slots % 32 == 0
    assert pk.max_win == lo_w[:, 1].max() < 2**16
    for k, (lo, width) in enumerate(lo_w):
        s0, s1 = bounds[k], bounds[k + 1]
        nz = vals[s0:s1] != 0
        assert nz.any() and lo % 4 == 0 and width % 4 == 0
        assert lo + width <= A.n_pad
        # Every nonzero slot's column lies in the window, at its local index.
        np.testing.assert_array_equal(lo + lcols[s0:s1][nz], cols[s0:s1][nz])
        assert (lcols[s0:s1] < width).all()
        # The window is the columns' span widened to multiples of 4.
        assert cols[s0:s1][nz].min() // 4 * 4 == lo
        assert cols[s0:s1][nz].max() // 4 * 4 + 3 == lo + width - 1
    assert fused_cg_plan(A).instance == "cluster"
    assert fused_cg_plan(A) is fused_cg_plan(A)  # built once per operator


@pytest.mark.parametrize("dims", PACK_DIMS, ids=mesh_id)
def test_cluster_product_matches_spmv_plain_and_jax(dims):
    _mesh, sy = jax_problem(dims)
    Aj = j_bsg_from_csr(sy.A)
    A = bsg_from_csr(port_csr(sy), device="cpu")
    pk = cluster_pack(A)
    x = rand(sy.A.n_rows, seed=11, dtype=np.float32)
    xp = A.put_vector(x)
    y = cluster_spmv_plain(A, pk, xp)
    assert torch.equal(y, spmv_plain(A, xp))
    yj = Aj.get_vector(j_bsg_spmv(Aj, Aj.put_vector(x), interpret=True))
    assert relerr(A.get_vector(y), yj) <= 1e-6


def test_cluster_pack_of_a_random_graph_of_one_cta():
    """A random graph in one CTA (n_pad 1,024): its window is the span of
    its columns, and a zero coefficient reads local column 0."""
    S = random_laplacian(700, 8, 0, shift=0.5).tolil()
    S[3, 5] = S[5, 3] = 0.0  # explicit zeros stay in the pattern
    S = S.tocsr()
    _Aj, A = _operators(S)
    pk = cluster_pack(A)
    assert pk.ctas == 1 and pk.windows.tolist() == [0, 700]
    lcols = pk.lcols.numpy().view(np.uint16)
    zero = (A.vals == 0).numpy()
    assert (lcols[zero] == 0).all()
    x = torch.from_numpy(rand(A.n_pad, seed=12, dtype=np.float32))
    assert torch.equal(cluster_spmv_plain(A, pk, x), spmv_plain(A, x))


@pytest.mark.parametrize("n_pad,max_slots,max_win,expect", [
    (16_384, 19_232, 3_364, "cluster"),  # the 16,028-DOF refined box
    (1_024, 32, 1, "cluster"),
    (16_385, 32, 1, "grid"),  # not a multiple of 1024 rows
    (17_408, 19_232, 3_364, "grid"),  # 16,385 rows padded: 17 CTAs
    (16_384, 37_000, 3_364, "grid"),  # slots past the budget
    (8_192, 19_232, 30_000, "grid"),  # window past the budget
    (8_192, 32, 2**16 + 1, "grid"),  # window past 16-bit columns
])
def test_fused_cg_instance_rule(n_pad, max_slots, max_win, expect):
    assert fused_cg_instance(n_pad, max_slots, max_win) == expect
    fits = (_kernels.cluster_smem_bytes(max_slots, max_win)
            <= _kernels.CLUSTER_SMEM_BUDGET)
    assert (expect == "cluster") <= fits


def test_fused_cg_solve_on_the_cpu_packs_nothing():
    """A CPU solve runs the plain recurrence on JAX's inverse diagonal and
    builds no plan (no cluster pack); a plan goes with its operator."""
    S = random_laplacian(700, 8, 15, shift=0.5)
    _Aj, A = _operators(S)
    res = fused_cg_solve(A, A.put_vector(S @ np.ones(700)), tol=1e-6,
                         maxiter=500)
    assert res.converged and id(A) not in fused_cg_mod._PLANS
    assert fused_cg_plan(A).instance == "cluster"
    key = id(A)
    assert key in fused_cg_mod._PLANS
    del A
    gc.collect()
    assert key not in fused_cg_mod._PLANS


def test_fused_cg_plan_takes_the_grid_off_the_1024_row_grain():
    """An operator padded to 8 rows (the identity-space sliced ELL of
    ``choose_operator``) is not packed: the grid instance, as before."""
    S = random_laplacian(700, 8, 14, shift=0.5)
    p = csr_from_numpy(S.indptr, S.indices, S.data, S.shape)
    A = bsg_from_csr(p, reorder=False, row_multiple=8, device="cpu")
    plan = fused_cg_plan(A)
    assert A.n_pad == 704 and plan.instance == "grid" and plan.pack is None
    res = fused_cg_solve(A, A.put_vector(S @ np.ones(700)), tol=1e-6,
                         maxiter=500)
    assert res.converged


def test_fused_cg_plan_takes_the_grid_past_16k_rows():
    """16,385 rows pad to 17,408: 17 CTAs, one more than a cluster holds;
    the plan does not pack them and keeps JAX's inverse diagonal."""
    S = random_laplacian(16_385, 4, 13, shift=0.5)
    _Aj, A = _operators(S)
    plan = fused_cg_plan(A)
    assert A.n_pad == 17_408 and plan.instance == "grid" and plan.pack is None
    assert torch.equal(plan.invd, _inverse_diagonal(A))
