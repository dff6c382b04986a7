"""The port's DIA storage, its plain product and the operator choice
against the JAX package (``ops/dia.py``, ``ops/pallas/dia_kernel.py``).

Both packages get the same assembled arrays (structured boxes from the JAX
package, plus a random matrix on wide diagonals); random vectors come from
numpy with fixed seeds.

Tolerances: the pack (offsets, diagonals, bfloat16 decision) must be
equal.  The plain product adds the same products in the same pairwise
order as JAX's ``DIAMatrix.matvec``, so the two differ by rounding only:
1e-6 relative in f32, 1e-12 in f64.  The Pallas kernel (interpret mode)
accumulates in f32 in diagonal order: 1e-6 relative in f32.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.io import box_mesh as j_box_mesh
from domain_decomposed_pde_solver_tpu.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu.ops import dia as j_dia
from domain_decomposed_pde_solver_tpu.ops.pallas.dia_kernel import dia_spmv_pallas
from domain_decomposed_pde_solver_tpu.solvers.precond.amg import (
    infer_free_grid as j_infer_free_grid,
)
from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
from domain_decomposed_pde_solver_tpu_torch.ops import dia as p_dia
from domain_decomposed_pde_solver_tpu_torch.ops.bsg import BSGMatrix
from domain_decomposed_pde_solver_tpu_torch.ops.csr import CSRMatrix
from domain_decomposed_pde_solver_tpu_torch.ops.dia_kernel import (
    dia_matvec_plain,
    dia_spmv,
)
from domain_decomposed_pde_solver_tpu_torch.utils.convert import dia_from_numpy
from torch_parity import jax_problem, port_csr, rand, relerr

torch.set_num_threads(1)

TOL = {"float32": 1e-6, "float64": 1e-12}
BOXES = [((9, 8, 7), "TETRA4"), ((8, 8, 8), "HEX8")]


def _box(shape, elem):
    mesh = j_box_mesh(*shape, elem_type=elem)
    sy = assemble_heat_system(mesh)
    return sy, port_csr(sy), j_infer_free_grid(mesh, sy.free_to_node)


def _wide_csr(n=600, mx=9, my=7, seed=0):
    """Random nonsymmetric matrix on diagonals reaching +-(mx*my + mx + 1),
    values not bf16-exact, rows near both ends cut by the range check."""
    rng = np.random.default_rng(seed)
    big = mx * my + mx + 1
    offs = np.array([-big, -mx * my, -mx, -1, 0, 1, mx, mx * my, big])
    rows, cols = [], []
    for o in offs:
        i = np.arange(max(0, -o), min(n, n - o))
        rows.append(i)
        cols.append(i + o)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return CSRMatrix(indptr=indptr, indices=cols.astype(np.int64),
                     data=rng.normal(size=rows.size), shape=(n, n))


def _jax_csr(csr):
    from domain_decomposed_pde_solver_tpu.ops.csr import CSRMatrix as JCSR

    return JCSR(indptr=csr.indptr, indices=csr.indices, data=csr.data,
                shape=csr.shape)


CASES = [("box", shape, elem) for shape, elem in BOXES] + [("wide", None, None)]


def _case(kind, shape, elem):
    if kind == "box":
        sy, csr, _dims = _box(shape, elem)
        return sy.A, csr
    csr = _wide_csr()
    return _jax_csr(csr), csr


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("kind,shape,elem", CASES,
                         ids=["tet9x8x7", "hex8", "wide"])
def test_pack_matches_jax(kind, shape, elem, name):
    jA, pA = _case(kind, shape, elem)
    uj, dj = j_dia.pack_dia_host(jA, dtype=getattr(jnp, name))
    up, dp = p_dia.pack_dia_host(pA, dtype=getattr(torch, name))
    np.testing.assert_array_equal(up, uj)
    np.testing.assert_array_equal(dp, dj)
    assert dp.dtype == dj.dtype
    assert p_dia._bf16_exact(pA.data) == j_dia._bf16_exact(jA.data)
    Aj = j_dia.dia_from_csr(jA, dtype=getattr(jnp, name))
    Ap = p_dia.dia_from_csr(pA, dtype=getattr(torch, name), device="cpu")
    assert Ap.offsets == Aj.offsets and Ap.n_pad == Aj.n_pad
    assert Ap.data.dtype == getattr(torch, str(Aj.data.dtype))
    assert Ap.dtype == getattr(torch, str(Aj.dtype))
    np.testing.assert_array_equal(Ap.data.float().numpy(),
                                  np.asarray(Aj.data, np.float32))
    assert (kind == "box") == (Ap.data.dtype == torch.bfloat16)


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("kind,shape,elem", CASES,
                         ids=["tet9x8x7", "hex8", "wide"])
def test_plain_matvec_matches_jax(kind, shape, elem, name):
    jA, pA = _case(kind, shape, elem)
    Aj = j_dia.dia_from_csr(jA, dtype=getattr(jnp, name))
    Ap = p_dia.dia_from_csr(pA, dtype=getattr(torch, name), device="cpu")
    x = rand(Ap.n_pad, seed=3).astype(name)
    yj = np.asarray(Aj.matvec(jnp.asarray(x)))
    yp = dia_matvec_plain(Ap, torch.from_numpy(x)).numpy()
    assert yp.dtype == np.dtype(name)
    assert relerr(yp, yj) <= TOL[name]
    # The wrapper on a CPU tensor is the plain version, bit for bit, and
    # both are the host CSR product on the logical rows.
    np.testing.assert_array_equal(Ap.matvec(torch.from_numpy(x)).numpy(), yp)
    ref = pA.matvec(x[: pA.n_rows].astype(np.float64))
    assert relerr(yp[: pA.n_rows], ref) <= TOL[name]


@pytest.mark.parametrize("kind,shape,elem", CASES,
                         ids=["tet9x8x7", "hex8", "wide"])
def test_plain_matvec_matches_jax_pallas_interpret_f32(kind, shape, elem):
    jA, pA = _case(kind, shape, elem)
    Aj = j_dia.dia_from_csr(jA, dtype=jnp.float32)
    Ap = p_dia.dia_from_csr(pA, dtype=torch.float32, device="cpu")
    x = rand(Ap.n_pad, seed=4, dtype=np.float32)
    yk = np.asarray(dia_spmv_pallas(Aj, jnp.asarray(x), chunk=256,
                                    interpret=True))
    yp = dia_matvec_plain(Ap, torch.from_numpy(x)).numpy()
    assert relerr(yp, yk) <= TOL["float32"]


def test_diagonal_padded_and_astype_match_jax():
    sy, csr, _dims = _box((9, 8, 7), "TETRA4")
    Aj = j_dia.dia_from_csr(sy.A, dtype=jnp.float64)
    Ap = p_dia.dia_from_csr(csr, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(Ap.diagonal_padded(7.0).numpy(),
                                  np.asarray(Aj.diagonal_padded(7.0)))
    full = Ap.astype(torch.float64)
    assert full.data.dtype == torch.float64 and full.compute_dtype == ""
    x = torch.from_numpy(rand(Ap.n_pad, seed=5))
    np.testing.assert_array_equal(full.matvec(x).numpy(), Ap.matvec(x).numpy())
    assert p_dia.operator_bytes(Ap) == j_dia.operator_bytes(Aj)


def test_dia_from_numpy_adopts_a_jax_operator():
    sy, _csr, _dims = _box((9, 8, 7), "TETRA4")
    Aj = j_dia.dia_from_csr(sy.A, dtype=jnp.float32)
    data = np.asarray(Aj.data)
    assert str(data.dtype) == "bfloat16"
    Ap = dia_from_numpy(Aj.offsets, data.view(np.uint16), Aj.n_rows,
                        compute_dtype="float32", device="cpu")
    x = rand(Ap.n_pad, seed=6, dtype=np.float32)
    np.testing.assert_array_equal(
        Ap.matvec(torch.from_numpy(x)).numpy(),
        np.asarray(Aj.matvec(jnp.asarray(x))),
    )


def _fmt(A) -> str:
    return type(A).__name__


@pytest.mark.parametrize(
    "elem,name,pad_stencil,expect",
    [
        ("TETRA4", "float32", "never", "StencilOperator"),
        ("TETRA4", "float32", "always", "PadStencilOperator"),
        ("HEX8", "float32", "never", "StencilOperator"),
        ("TETRA4", "float64", "never", "DIAMatrix"),
        ("TETRA4", "float64", "always", "DIAMatrix"),
    ],
)
def test_choose_operator_picks_the_jax_format(elem, name, pad_stencil, expect):
    sy, csr, dims = _box((9, 8, 7), elem)
    Aj = j_dia.choose_operator(sy.A, dtype=getattr(jnp, name),
                               grid_dims=dims, pad_stencil=pad_stencil)
    Ap = p_dia.choose_operator(csr, dtype=getattr(torch, name),
                               grid_dims=dims, pad_stencil=pad_stencil,
                               device="cpu")
    assert _fmt(Ap) == _fmt(Aj) == expect
    # Without grid_dims a box is DIA in both.
    assert _fmt(p_dia.choose_operator(csr, dtype=torch.float32,
                                      device="cpu")) == "DIAMatrix"
    assert _fmt(j_dia.choose_operator(sy.A, dtype=jnp.float32)) == "DIAMatrix"


def test_choose_operator_pad_stencil_auto_means_cuda():
    """JAX's "auto" asks for a TPU; the port's asks for a CUDA device, so on
    a CPU device both keep the identity-layout stencil."""
    sy, csr, dims = _box((9, 8, 7), "TETRA4")
    Aj = j_dia.choose_operator(sy.A, dtype=jnp.float32, grid_dims=dims,
                               pad_stencil="auto")
    Ap = p_dia.choose_operator(csr, dtype=torch.float32, grid_dims=dims,
                               pad_stencil="auto", device="cpu")
    assert _fmt(Ap) == _fmt(Aj) == "StencilOperator"


def test_choose_operator_unstructured_goes_to_sliced_ell():
    """A refined (unstructured) box has too many diagonals for DIA: JAX
    takes Split-ELL or ELL on a CPU, the port its sliced-ELL operator in
    the identity space (padded to 8 like JAX's ELL), or the RCM one with
    ``bsg="auto"``."""
    _mesh, sy = jax_problem((7, 6, 5))
    csr = port_csr(sy)
    assert j_dia.pack_dia_host(sy.A) is None
    Aj = j_dia.choose_operator(sy.A, dtype=jnp.float64)
    assert _fmt(Aj) in ("SplitELLMatrix", "ELLMatrix")
    Ap = p_dia.choose_operator(csr, dtype=torch.float64, device="cpu")
    assert isinstance(Ap, BSGMatrix) and Ap.perm is None
    assert Ap.n_pad == Aj.n_pad
    x = rand(csr.n_rows, seed=7)
    assert relerr(Ap.get_vector(Ap.matvec(Ap.put_vector(x, torch.float64))),
                  sy.A.matvec(x)) <= TOL["float64"]


def test_wrapper_dispatch_by_device():
    """On a CPU tensor the wrapper takes the plain version; the launch
    function refuses anything but CUDA tensors, before building."""
    csr = _wide_csr(n=64, mx=3, my=2)
    A = p_dia.dia_from_csr(csr, dtype=torch.float64, device="cpu")
    x = torch.from_numpy(rand(A.n_pad, seed=8))
    np.testing.assert_array_equal(dia_spmv(A, x).numpy(),
                                  dia_matvec_plain(A, x).numpy())
    before = _kernels.DIA_SPMV.launches
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.dia_spmv_launch(A.data, A.offsets, x)
    assert _kernels.DIA_SPMV.launches == before
    with pytest.raises(TypeError, match="float64"):
        dia_spmv(A, x.float())  # f64 storage needs f64 vectors
    with pytest.raises(ValueError):
        dia_spmv(A, x[:-1])


@pytest.mark.parametrize("n,nd,expect", [
    (4_920, 19, (19, 128)),  # level 1
    (216, 23, (23, 128)),  # level 2
    (8_384, 19, (19, 128)),  # path B
    (40, 27, (27, 128)),  # HEX8, tiny
    (1_009_904, 19, (19, 256)),  # 1M
    (1_009_904, 27, (27, 256)),
    (5_000, 11, (0, 128)),  # run-time loop
    (300_000, 7, (0, 256)),
])
def test_dia_launch_shape_rule(n, nd, expect):
    """Kernel 4's launch rule is a pure function of the operator's size:
    the compiled instance of 19, 23 or 27 diagonals (the counts of the
    structured routes' DIA levels), else the run-time loop; 128-thread
    blocks below 2^17 rows, 256 above."""
    shape = _kernels.dia_launch_shape(n, nd)
    assert (shape.instance, shape.block) == expect
    assert shape.block in _kernels.DIA_BLOCKS


def test_dia_offsets_array_is_built_once():
    """The launch passes the operator's cached int64 offsets as they are."""
    csr = _wide_csr(n=64, mx=3, my=2)
    A = p_dia.dia_from_csr(csr, dtype=torch.float32, device="cpu")
    offs = A.offsets_array
    assert offs is A.offsets_array  # cached
    assert offs.dtype == np.int64 and offs.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(offs, np.asarray(A.offsets))
    assert np.ascontiguousarray(offs, dtype=np.int64) is offs  # no copy
