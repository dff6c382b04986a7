"""The port on the card: the hand-written SpMV kernel against its plain
PyTorch version, and the slice through the kernel against the same slice
on the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without JAX (``tests/conftest.py`` imports JAX; skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Kernel tolerances: the kernel and ``spmv_plain`` add the same products in
the same order, the kernel with fused multiply-adds, so they differ by
rounding only: 1e-5 relative in f32, 1e-12 in f64.
"""

import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu_torch import SteadyHeatSolver
from domain_decomposed_pde_solver_tpu_torch.io import box_mesh, refine_uniform
from domain_decomposed_pde_solver_tpu_torch.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
from domain_decomposed_pde_solver_tpu_torch.ops.bsg import (
    bsg_from_coo,
    bsg_from_csr,
    bsg_spmv,
    spmv_plain,
)

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "float64": 1e-12}
BC = {100: 80.0, 1000: 25.0}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the port's hand-written kernels)")
    return torch.device("cuda", 0)


def _relerr(a, b) -> float:
    a = a.double().cpu()
    b = b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _mesh():
    return refine_uniform(box_mesh(8, 8, 8, elem_type="TETRA4"), 1)


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_kernel_matches_plain_square(cuda_device, name):
    sy = assemble_heat_system(_mesh())
    A = bsg_from_csr(sy.A, device=cuda_device)
    rng = np.random.default_rng(11)
    x = A.put_vector(rng.normal(size=sy.A.n_rows), dtype=getattr(torch, name))
    before = _kernels.SELL_SPMV.launches
    y = bsg_spmv(A, x)
    assert _kernels.SELL_SPMV.launches == before + 1
    torch.cuda.synchronize()
    assert y.device == cuda_device and y.dtype == x.dtype
    assert _relerr(y, spmv_plain(A, x)) <= TOL[name]
    y_host = A.get_vector(y)
    ref = sy.A.matvec(A.get_vector(x).astype(np.float64))
    assert np.abs(y_host - ref).max() <= TOL[name] * np.abs(ref).max()


@pytest.mark.parametrize("storage", ["float32", "float64"])
def test_kernel_matches_plain_rectangular_with_empty_rows(cuda_device, storage):
    rng = np.random.default_rng(12)
    n_rows, x_len = 3000, 2000
    live = rng.random(n_rows) < 0.5
    live[500:600] = False
    rows = np.repeat(np.flatnonzero(live), rng.integers(1, 25, live.sum()))
    cols = rng.integers(0, x_len, rows.size)
    A = bsg_from_coo(rows, cols, rng.normal(size=rows.size), n_rows, x_len,
                     storage=storage, device=cuda_device)
    x = torch.as_tensor(rng.normal(size=x_len - 5),
                        dtype=getattr(torch, storage), device=cuda_device)
    y = bsg_spmv(A, x)
    assert _relerr(y, spmv_plain(A, x)) <= TOL[storage]
    y = y.cpu().numpy()
    assert np.all(y[:n_rows][~live] == 0) and np.all(y[n_rows:] == 0)


def test_kernel_refuses_mixed_inputs(cuda_device):
    A = bsg_from_coo([0, 1], [1, 0], [2.0, 3.0], 2, 2, storage="float64",
                     device=cuda_device)
    with pytest.raises(TypeError):
        bsg_spmv(A, torch.ones(2, device=cuda_device))  # f64 storage, f32 x
    with pytest.raises(ValueError):
        bsg_spmv(A, torch.ones(2, dtype=torch.float64))  # x on the CPU


@pytest.mark.parametrize("name,slack", [("float64", 0), ("float32", 1)])
def test_slice_on_the_card_matches_the_cpu(cuda_device, name, slack):
    dtype = getattr(torch, name)
    tol = 1e-10 if name == "float64" else 1e-6
    mesh = _mesh()
    gpu = SteadyHeatSolver(mesh, dtype=dtype, device=cuda_device)
    cpu = SteadyHeatSolver(mesh, dtype=dtype)
    _kernels.SELL_SPMV.launches = 0
    u1, r1 = gpu.solve(tol=tol)
    u2, r2 = gpu.solve(bc=BC, tol=tol)
    assert _kernels.SELL_SPMV.launches > 0
    c1, q1 = cpu.solve(tol=tol)
    c2, q2 = cpu.solve(bc=BC, tol=tol)
    for r, q, u, c in ((r1, q1, u1, c1), (r2, q2, u2, c2)):
        assert r.converged and q.converged
        assert abs(r.iterations - q.iterations) <= slack
        scale = np.abs(c).max()
        assert np.abs(u - c).max() <= (1e-10 if name == "float64" else 1e-4) * scale
