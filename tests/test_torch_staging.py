"""The put and get of a request's vectors (``ops/ell.py::stage_vector`` and
``fetch_vector``), through every operator's ``put_vector``/``get_vector``:
the sliced-ELL operator with and without its permutation, the pad-stencil
operator from f64 and f32 host vectors into f32 and f64 device vectors,
and the identity padded layout.

``put_vector`` uploads the real entries and lays them out on the device;
it must give, bit for bit, the padded vector a host construction gives
(the plain versions below), pads included.  ``get_vector`` hands back a
new array the caller owns.  On the CPU; the card's own cases (page-locked
buffers, their byte counts) are in ``tests/test_torch_trace.py``.
"""

import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
from domain_decomposed_pde_solver_tpu_torch.models import structured
from domain_decomposed_pde_solver_tpu_torch.models.heat import (
    assemble_heat_system,
)
from domain_decomposed_pde_solver_tpu_torch.ops.bsg import bsg_from_csr
from domain_decomposed_pde_solver_tpu_torch.ops.ell import ell_from_csr
from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
    pad_stencil_from_parts,
)

F32, F64 = torch.float32, torch.float64


def _bsg_reference(A, x, dtype):
    out = torch.zeros(A.n_pad, dtype=dtype)
    xt = torch.as_tensor(np.asarray(x), dtype=dtype)
    if A.perm is not None:
        out[A.perm.cpu()] = xt
    else:
        out[: A.n_rows] = xt
    return out


def _pad_stencil_reference(A, x, dtype):
    mx, my, mz = A.dims
    x3 = torch.zeros((A.Z, A.myp, A.mxp), dtype=dtype)
    x3[1 : mz + 1, 1 : my + 1, :mx] = torch.as_tensor(
        np.asarray(x)).reshape(mz, my, mx).to(dtype)
    return x3.reshape(-1)


def _padded_reference(A, x, dtype):
    xt = torch.as_tensor(np.asarray(x))
    out = torch.zeros(A.n_pad, dtype=xt.dtype if dtype is None else dtype)
    out[: xt.numel()] = xt
    return out


@pytest.fixture(scope="module")
def heat():
    return assemble_heat_system(box_mesh(5, 4, 3, "TETRA4"))


@pytest.fixture(scope="module")
def operators(heat):
    parts = structured.structured_box_parts(9, 8, 7, device="cpu")
    return {
        "bsg_perm": bsg_from_csr(heat.A, device="cpu"),
        "bsg_plain": bsg_from_csr(heat.A, reorder=False, device="cpu"),
        "pad_stencil": pad_stencil_from_parts(parts["parts"], device="cpu"),
        "padded": ell_from_csr(heat.A, device="cpu"),
    }


# (operator, host dtype, device dtype, plain version)
CASES = {
    "bsg_perm-f64-f32": ("bsg_perm", np.float64, F32, _bsg_reference),
    "bsg_plain-f64-f32": ("bsg_plain", np.float64, F32, _bsg_reference),
    "bsg_perm-f64-f64": ("bsg_perm", np.float64, F64, _bsg_reference),
    "pad_stencil-f64-f32": ("pad_stencil", np.float64, F32,
                            _pad_stencil_reference),
    "pad_stencil-f64-f64": ("pad_stencil", np.float64, F64,
                            _pad_stencil_reference),
    "pad_stencil-f32-f32": ("pad_stencil", np.float32, F32,
                            _pad_stencil_reference),
    "pad_stencil-f32-f64": ("pad_stencil", np.float32, F64,
                            _pad_stencil_reference),
    "padded-f64-kept": ("padded", np.float64, None, _padded_reference),
    "padded-f64-f32": ("padded", np.float64, F32, _padded_reference),
}


@pytest.fixture(params=sorted(CASES))
def case(request, operators):
    name, host, dtype, reference = CASES[request.param]
    A = operators[name]
    if name == "bsg_perm":
        assert A.perm is not None
    if name == "bsg_plain":
        assert A.perm is None
    # Values whose f64 -> f32 rounding is not exact, and a signed zero.
    x = np.random.default_rng(7).uniform(-3, 3, A.n_rows).astype(host)
    x[0] = -0.0
    return A, x, dtype, reference


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint8)


def _overlaps(a: np.ndarray, t: torch.Tensor) -> bool:
    lo = a.__array_interface__["data"][0]
    st = t.untyped_storage()
    return lo < st.data_ptr() + st.nbytes() and st.data_ptr() < lo + a.nbytes


def test_put_vector_is_the_host_construction(case):
    A, x, dtype, reference = case
    kept = x.copy()
    got = A.put_vector(x) if dtype is None else A.put_vector(x, dtype=dtype)
    want = reference(A, kept, dtype)
    assert got.dtype == want.dtype and got.shape == (A.n_pad,)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # The device vector is its own: the caller's array may change after.
    x[:] = 9.0
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_get_vector_round_trips(case):
    A, x, dtype, _reference = case
    xd = A.put_vector(x) if dtype is None else A.put_vector(x, dtype=dtype)
    got = A.get_vector(xd)
    assert isinstance(got, np.ndarray) and got.shape == (A.n_rows,)
    want = x if dtype is None else x.astype(
        np.float32 if dtype == F32 else np.float64)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_get_vector_hands_back_the_callers_own_array(case):
    A, x, dtype, _reference = case
    xd = A.put_vector(x) if dtype is None else A.put_vector(x, dtype=dtype)
    first = A.get_vector(xd)
    want = first.copy()
    tensors = [xd] + [v for v in vars(A).values()
                      if isinstance(v, torch.Tensor)]
    assert not [t for t in tensors if _overlaps(first, t)]
    first[:] = -1.0
    second = A.get_vector(xd)
    assert not np.shares_memory(first, second)
    np.testing.assert_array_equal(second, want)
