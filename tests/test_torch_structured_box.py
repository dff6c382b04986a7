"""The port's scan-free structured assembly (``models/structured.py``) and
the 10M box's route against the JAX package and the port's element path.

The CSR, b, degree, index maps and boundary pairs must be bit-identical to
``assemble_heat_system(box_mesh(...))`` (the port's element path) and to
JAX's ``structured_box_system`` at every size, parity and element type of
JAX's own test (``tests/test_structured.py``); the stencil parts, b and
degree of ``structured_box_parts`` bit-identical to JAX's (numpy and
device builds alike: the closed form is small-integer arithmetic, exact in
float32).  The 10M route (``bench10m.py``: structured system, structured
parts, pad-stencil operator, brick AMG over it, CG+AMG to 1e-6 and
refinement to 1e-8 with a staged f64 right-hand side and the residual on
the device) runs at N = 26 (25 x 27 x 27 = 18,225 DOF) in both packages:
refinement sweeps equal, inner iterations within one per sweep and CG+AMG
iterations within one (f32 rounding moves the stopping iteration), answers
within 1e-6 relative (f32 inner solves).
"""

import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.io.boxmesh import box_mesh as j_box_mesh
from domain_decomposed_pde_solver_tpu.models import (
    assemble_heat_system as j_assemble,
)
from domain_decomposed_pde_solver_tpu.models import structured as j_st
from domain_decomposed_pde_solver_tpu.ops.pallas.stencil_kernel import (
    pad_stencil_from_parts as j_pad_from_parts,
)
from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
from domain_decomposed_pde_solver_tpu_torch.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu_torch.models import structured as p_st
from domain_decomposed_pde_solver_tpu_torch.ops.dia import choose_operator
from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
    pad_stencil_from_parts,
)
from domain_decomposed_pde_solver_tpu_torch.solvers.cg import cg_solve
from domain_decomposed_pde_solver_tpu_torch.solvers.mixed import (
    iterative_refinement_solve,
)
from domain_decomposed_pde_solver_tpu_torch.solvers.precond import amg as p_amg
from domain_decomposed_pde_solver_tpu_torch.utils.convert import (
    heat_system_from_numpy,
)
from torch_parity import jax_box10m_route, relerr

torch.set_num_threads(1)

CASES = [
    (8, 8, 8, "TETRA4"),
    (9, 8, 7, "TETRA4"),  # odd/even mixes cover all parity classes
    (16, 10, 12, "TETRA4"),
    (13, 9, 11, "TETRA4"),
    (8, 9, 10, "HEX8"),
    (11, 11, 11, "HEX8"),
]
PART_CASES = [(8, 8, 8, "TETRA4"), (16, 10, 12, "TETRA4"), (8, 9, 10, "HEX8")]
SYSTEM_FIELDS = ("b", "degree", "free_to_node", "node_to_free", "bdry_rows",
                 "bdry_cols")


def _assert_same_system(got, ref, pairs=True):
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(np.asarray(getattr(got.A, f)),
                                      np.asarray(getattr(ref.A, f)))
    fields = SYSTEM_FIELDS if pairs else SYSTEM_FIELDS[:4]
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))


@pytest.mark.parametrize("nx,ny,nz,et", CASES)
def test_structured_system_bit_identical(nx, ny, nz, et):
    got = p_st.structured_box_system(nx, ny, nz, elem_type=et)
    assert got.mesh is None
    # The port's element path (its own probe's source), and JAX's structured
    # system (whose boundary pairs share the closed form).
    mesh = box_mesh(nx, ny, nz, elem_type=et)
    _assert_same_system(got, assemble_heat_system(mesh), pairs=False)
    _assert_same_system(got, j_st.structured_box_system(nx, ny, nz,
                                                        elem_type=et))
    # The boundary pairs rebuild b exactly (the rhs_for contract).
    bv = np.zeros(got.A.n_rows)
    _, bval = mesh.boundary_value_per_node()
    np.add.at(bv, got.bdry_rows, bval[got.bdry_cols])
    np.testing.assert_array_equal(bv, got.b)


def test_structured_custom_bc_ids():
    got = p_st.structured_box_system(9, 8, 8, bc_ids=(7, 42))
    ref = assemble_heat_system(box_mesh(9, 8, 8, elem_type="TETRA4",
                                        bc_ids=(7, 42)))
    _assert_same_system(got, ref, pairs=False)
    _assert_same_system(got, j_st.structured_box_system(9, 8, 8,
                                                        bc_ids=(7, 42)))


def test_structured_small_grid_falls_back():
    """A free dimension under 7 is outside the verified stencil territory:
    the builder takes the element path (still exact), as JAX's does."""
    got = p_st.structured_box_system(5, 5, 5)
    assert got.mesh is not None
    ref = j_st.structured_box_system(5, 5, 5)
    _assert_same_system(got, ref, pairs=False)
    assert p_st.structured_box_parts(5, 5, 5) is None
    assert j_st.structured_box_parts(5, 5, 5) is None


@pytest.mark.parametrize("et", ["TETRA4", "HEX8"])
def test_lattice_tables_match_jax_and_are_cached(et):
    got, ref = p_st.box_lattice_tables(et), j_st.box_lattice_tables(et)
    assert got is p_st.box_lattice_tables(et)
    assert set(got) == set(ref)
    for k in got:
        if isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
        else:
            assert got[k] == ref[k], k


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("device", [False, "cpu"], ids=["numpy", "torch"])
@pytest.mark.parametrize("nx,ny,nz,et", PART_CASES)
def test_parts_bit_identical_to_jax(nx, ny, nz, et, device):
    """``device=False`` (numpy) and the torch build (on the CPU here; on the
    card in ``tests/test_torch_cuda.py``) against JAX's numpy and device
    builds and the assembled system."""
    out = p_st.structured_box_parts(nx, ny, nz, elem_type=et, device=device)
    if device:
        assert all(isinstance(out[k], torch.Tensor) for k in ("b", "degree"))
        assert isinstance(out["parts"]["corr_pad"], torch.Tensor)
    sy = j_assemble(j_box_mesh(nx, ny, nz, elem_type=et))
    n = sy.n_free
    for jdev in (False, True):
        ref = j_st.structured_box_parts(nx, ny, nz, elem_type=et,
                                        device=jdev)
        for k in ("taps", "dims", "period", "groups", "group_const",
                  "n_rows", "n_pad"):
            assert out["parts"][k] == ref["parts"][k], k
        for k in ("pats", "const_vals", "corr_pad"):
            np.testing.assert_array_equal(_host(out["parts"][k]),
                                          np.asarray(ref["parts"][k]))
        for k in ("b", "degree"):
            np.testing.assert_array_equal(_host(out[k]), np.asarray(ref[k]))
    np.testing.assert_array_equal(_host(out["b"])[:n], sy.b.astype(np.float32))
    np.testing.assert_array_equal(_host(out["degree"])[:n],
                                  sy.degree.astype(np.float32))


@pytest.mark.parametrize("device", [False, "cpu"], ids=["numpy", "torch"])
@pytest.mark.parametrize("nx,ny,nz,et", [(16, 10, 12, "TETRA4"),
                                         (8, 9, 10, "HEX8")])
def test_pad_operator_from_parts_is_the_csr_route(nx, ny, nz, et, device):
    """``pad_stencil_from_parts`` of the structured parts builds the
    operator ``choose_operator`` builds from the assembled CSR (the same
    space and arrays), and its product is the matrix's."""
    out = p_st.structured_box_parts(nx, ny, nz, elem_type=et, device=device)
    A = pad_stencil_from_parts(out["parts"], device="cpu")
    sy = p_st.structured_box_system(nx, ny, nz, elem_type=et)
    dims = (nx - 1, ny + 1, nz + 1)
    B = choose_operator(sy.A, dtype=torch.float32, grid_dims=dims,
                        pad_stencil="always", device="cpu")
    assert (A.dims, A.myp, A.mxp, A.bz, A.n_pad, A.taps, A.groups) == (
        B.dims, B.myp, B.mxp, B.bz, B.n_pad, B.taps, B.groups)
    assert A.corr.dtype == B.corr.dtype
    for f in ("corr", "pats", "quads", "const_vals"):
        assert torch.equal(getattr(A, f), getattr(B, f)), f
    x = np.random.default_rng(3).standard_normal(sy.n_free)
    for dt in (torch.float32, torch.float64):
        y = A.get_vector(A.matvec(A.put_vector(x, dtype=dt)))
        tol = 1e-6 if dt == torch.float32 else 1e-13
        assert relerr(y, sy.A.matvec(x)) <= tol


@pytest.mark.parametrize("jdev", [False, True], ids=["numpy", "device"])
def test_pad_operator_from_jax_structured_parts(jdev):
    """JAX's ``structured_box_parts(...)["parts"]`` as it is (a device
    build's ``corr_pad`` is a JAX array, read through ``np.asarray``)."""
    ref = j_st.structured_box_parts(16, 10, 12, device=jdev)
    A = pad_stencil_from_parts(ref["parts"], device="cpu")
    Aj = j_pad_from_parts(ref["parts"])
    assert (A.Z, A.myp, A.mxp) == (Aj.Z, Aj.myp, Aj.mxp)
    x = np.random.default_rng(4).standard_normal(A.n_rows).astype(np.float32)
    y = A.get_vector(A.matvec(A.put_vector(x)))
    yj = np.asarray(Aj.get_vector(Aj.matvec(Aj.put_vector(x))))
    assert relerr(y, yj) <= 1e-6


def test_heat_system_from_numpy_carries_a_jax_structured_system():
    ref = j_st.structured_box_system(9, 8, 7)
    A = ref.A
    got = heat_system_from_numpy(
        A.indptr, A.indices, A.data, A.shape, ref.b, ref.free_to_node,
        num_nodes=ref.node_to_free.size, bdry_rows=ref.bdry_rows,
        bdry_cols=ref.bdry_cols)
    assert got.mesh is None and ref.mesh is None
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got.A, f),
                                      np.asarray(getattr(A, f)))
    for f in SYSTEM_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))


ROUTE_N = 26  # free grid 25 x 27 x 27, 18,225 DOF; hierarchy [18225, 125]


def _port_route(N, device):
    """The same route through the port's public functions."""
    sy = p_st.structured_box_system(N, N, N)
    parts = p_st.structured_box_parts(N, N, N, device=device)
    A = pad_stencil_from_parts(parts["parts"], device="cpu")
    M = p_amg.smoothed_aggregation_setup(
        sy.A, dtype=torch.float32, grid_dims=(N - 1, N + 1, N + 1),
        fine_operator=A)
    bh = (sy.b / np.abs(sy.b).max()).astype(np.float32)
    b = A.put_vector_sparse(bh)
    r = cg_solve(A, b, torch.zeros_like(b), precond=M, tol=1e-6, maxiter=100)
    b64 = sy.b.astype(np.float64)
    mr = iterative_refinement_solve(
        sy.A, b64, tol=1e-8, inner_tol=1e-6, inner_maxiter=100, precond=M,
        operator=A, b_device=A.put_vector_sparse(b64, dtype=torch.float64),
        device_residual=True)
    return sy, M, r, mr


@pytest.mark.parametrize("device", [False, "cpu"], ids=["numpy", "torch"])
def test_ten_million_route_matches_jax_at_small_n(device):
    _jsy, jM, jr, jmr = jax_box10m_route(ROUTE_N)
    sy, M, r, mr = _port_route(ROUTE_N, device)
    assert [l.n_rows for l in M.levels] == [l.n_rows for l in jM.levels] \
        == [18225, 125]
    assert [type(l.A).__name__ for l in M.levels] == [
        "PadStencilOperator", "DIAMatrix"]
    assert type(M.levels[0].P).__name__ == "PadBrickProlongator"
    assert r.converged and bool(jr.converged)
    assert abs(r.iterations - int(jr.iterations)) <= 1
    assert mr.converged and jmr.converged
    assert mr.refinements == jmr.refinements
    assert abs(mr.inner_iterations - jmr.inner_iterations) <= jmr.refinements
    host = np.linalg.norm(sy.b - sy.A.matvec(mr.x)) / np.linalg.norm(sy.b)
    assert host <= 1.5e-8
    assert relerr(mr.x, jmr.x) <= 1e-6
    assert 100.0 <= mr.x.min() and mr.x.max() <= 1000.0
