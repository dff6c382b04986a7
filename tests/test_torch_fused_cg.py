"""The port's fused Jacobi-PCG (``solvers/fused_cg.py``) against the JAX
package's, on the graphs of ``tests/test_fused_cg.py``.

JAX runs its whole-solve Pallas kernel in interpret mode here (as that
file runs it); the port runs ``fused_cg_solve(device="cpu")``, which is
``fused_cg_plain``, the kernel's recurrence in plain PyTorch.  The CUDA
kernel itself is held to ``fused_cg_plain`` on the card
(``tests/test_torch_cuda.py``).

Tolerances: both are float32 CG to 1e-6 with the same stopping test on
squared norms; their dots add in different orders, so they stop within 2
iterations of each other (the JAX file's own bound against the unfused
solver), and the answer's host f64 relative residual is < 5e-6.
"""

import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.ops.bsg import bsg_from_csr as j_bsg_from_csr
from domain_decomposed_pde_solver_tpu.ops.csr import CSRMatrix
from domain_decomposed_pde_solver_tpu.solvers.fused_cg import (
    fused_cg_solve as j_fused_cg_solve,
)
from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
from domain_decomposed_pde_solver_tpu_torch.ops.bsg import bsg_from_csr
from domain_decomposed_pde_solver_tpu_torch.solvers import (
    cg_solve,
    fused_cg_solve,
    jacobi_preconditioner,
)
from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
    _inverse_diagonal,
)
from domain_decomposed_pde_solver_tpu_torch.utils.convert import csr_from_numpy
from torch_parity import random_laplacian

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
