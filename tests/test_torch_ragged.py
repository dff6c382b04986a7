"""The ragged (chunked) layout of the port's unstructured operator against
the JAX package's ragged BSG layout.

JAX packs ``bsg_from_csr(..., layout="ragged", chunk=c)`` and evaluates it
with its chunk-grid Pallas kernel in interpret mode (as
``tests/test_bsg.py`` does); the port packs the same matrix with
``layout="ragged", chunk=c`` and evaluates :func:`spmv_plain`, the plain
version of its chunked kernel.  A JAX chunk is ``c`` micro-ops of one
tile; a port chunk is ``c`` slot columns of one 32-row slice.  The layouts
differ, the product does not: results are compared in original order.

Tolerances: 1e-6 relative in f32 (the same float32 products added in
another order), 1e-12 in f64 between the port's two layouts.
"""

import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.ops.bsg import bsg_from_csr as j_bsg_from_csr
from domain_decomposed_pde_solver_tpu.ops.bsg import bsg_spmv as j_bsg_spmv
from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
from domain_decomposed_pde_solver_tpu_torch.ops.bsg import (
    SLICE,
    WARP_CHUNKS,
    bsg_from_coo,
    bsg_from_csr,
    bsg_spmv,
    spmv_plain,
)
from domain_decomposed_pde_solver_tpu_torch.utils.convert import csr_from_numpy
from torch_parity import (
    MESH_DIMS,
    jax_problem,
    port_csr,
    random_laplacian,
    relerr,
)

torch.set_num_threads(1)


def _both(S):
    from domain_decomposed_pde_solver_tpu.ops.csr import CSRMatrix

    j = CSRMatrix(indptr=S.indptr.astype(np.int64),
                  indices=S.indices.astype(np.int64),
                  data=S.data.astype(np.float64), shape=S.shape)
    return j, csr_from_numpy(S.indptr, S.indices, S.data, S.shape)


@pytest.mark.parametrize("chunk", [3, 4, 16])
def test_ragged_product_matches_jax_ragged_kernel(chunk):
    S = random_laplacian(4000, 14, 21)
    jcsr, pcsr = _both(S)
    Aj = j_bsg_from_csr(jcsr, chunk=chunk, layout="ragged")
    Ap = bsg_from_csr(pcsr, chunk=chunk, layout="ragged", device="cpu")
    assert Aj.tmap is not None and Ap.layout == "ragged" and Ap.chunk == chunk
    x = np.random.default_rng(21).standard_normal(4000).astype(np.float32)
    yj = Aj.get_vector(np.asarray(j_bsg_spmv(Aj, Aj.put_vector(x),
                                             interpret=True)))
    yp = Ap.get_vector(bsg_spmv(Ap, Ap.put_vector(x)))
    assert relerr(yp, yj) <= 1e-6
    assert relerr(yp, S @ x.astype(np.float64)) <= 1e-6


@pytest.mark.parametrize("name,tol", [("float32", 1e-6), ("float64", 1e-12)])
@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_ragged_matches_dense_on_the_heat_operator(chunk, name, tol):
    _mesh, sy = jax_problem(MESH_DIMS[0])
    csr = port_csr(sy)
    D = bsg_from_csr(csr, device="cpu")
    R = bsg_from_csr(csr, layout="ragged", chunk=chunk, device="cpu")
    assert torch.equal(R.perm, D.perm) and R.n_pad == D.n_pad
    x = R.put_vector(np.random.default_rng(22).normal(size=sy.A.n_rows),
                     dtype=getattr(torch, name))
    before = _kernels.SELL_CHUNKED_SPMV.launches
    y = R.matvec(x)
    assert _kernels.SELL_CHUNKED_SPMV.launches == before  # CPU: plain only
    assert y.dtype == x.dtype
    assert relerr(R.get_vector(y), D.get_vector(D.matvec(x))) <= tol
    ref = sy.A.matvec(R.get_vector(x).astype(np.float64))
    assert relerr(R.get_vector(y), ref) <= (1e-6 if name == "float32" else 1e-12)


@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_ragged_layout_structure(chunk):
    """The ragged layout stores the dense layout's slots and only cuts each
    slice into chunks: ceil(w / chunk) per slice, the last one short, none
    for an empty slice; the chunks of slices of more than WARP_CHUNKS
    chunks are listed in ``wide``."""
    _mesh, sy = jax_problem(MESH_DIMS[1])
    csr = port_csr(sy)
    D = bsg_from_csr(csr, device="cpu")
    R = bsg_from_csr(csr, layout="ragged", chunk=chunk, device="cpu")
    assert R.n_slots == D.n_slots
    assert torch.equal(R.slice_ptr, D.slice_ptr)
    assert torch.equal(R.cols, D.cols) and torch.equal(R.vals, D.vals)
    widths = np.diff(R.slice_ptr.numpy()) // SLICE
    per_slice = -(-widths // chunk)  # ceil(width / chunk)
    assert R.tmap.dtype == torch.int32 and R.chunk_ptr.dtype == torch.int32
    tmap = R.tmap.numpy()
    assert (np.diff(tmap) >= 0).all()
    np.testing.assert_array_equal(np.bincount(tmap, minlength=widths.size),
                                  per_slice)
    np.testing.assert_array_equal(np.diff(R.chunk_ptr.numpy()), per_slice)
    assert R.n_chunks == int(per_slice.sum())
    # Empty slices (the padded tail) own no chunk.
    assert (widths == 0).any() and (per_slice[widths == 0] == 0).all()
    # Chunk widths: full but for each slice's last, which holds the rest.
    key = R.slot_key().numpy()
    chunk_slots = np.bincount(key // SLICE, minlength=R.n_chunks) // SLICE
    last = R.chunk_ptr.numpy()[1:][per_slice > 0] - 1
    np.testing.assert_array_equal(
        chunk_slots[last], widths[per_slice > 0] - chunk * (
            per_slice[per_slice > 0] - 1))
    full = np.setdiff1d(np.arange(R.n_chunks), last)
    assert (chunk_slots[full] == chunk).all()
    if chunk > 1:
        assert (chunk_slots[last] < chunk).any()  # a short last chunk
    # Wide slices: more than WARP_CHUNKS chunks, listed chunk by chunk.
    wide = per_slice > WARP_CHUNKS
    assert wide.any() == (chunk < 16)  # RCM widths here are 14 to 21
    np.testing.assert_array_equal(R.wide.numpy(),
                                  np.flatnonzero(wide[tmap]))
    assert R.wide.dtype == torch.int32


def test_ragged_keeps_empty_slices_without_chunks():
    rows = np.r_[np.arange(32), np.arange(64, 96)]  # slice 1 empty
    indptr = np.zeros(129, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=128), out=indptr[1:])
    csr = csr_from_numpy(indptr, rows, np.full(rows.size, 2.0), (128, 128))
    R = bsg_from_csr(csr, reorder=False, layout="ragged", chunk=4,
                     device="cpu")
    assert R.chunk_ptr.numpy()[:4].tolist() == [0, 1, 1, 2]
    y = spmv_plain(R, torch.ones(R.n_pad))
    assert torch.equal(y[:128], torch.as_tensor(np.where(
        np.isin(np.arange(128), rows), 2.0, 0.0), dtype=torch.float32))


def test_auto_layout_keeps_dense():
    """JAX's rule picks ragged only where the chunked form is smaller.  The
    port's two layouts store the same slots, so the chunked form never is:
    auto is the dense layout, slot for slot."""
    _mesh, sy = jax_problem(MESH_DIMS[1])
    csr = port_csr(sy)
    A = bsg_from_csr(csr, device="cpu")
    assert A.layout == "dense" and A.chunk == 0 and A.tmap is None
    D = bsg_from_csr(csr, layout="dense", device="cpu")
    assert torch.equal(A.slice_ptr, D.slice_ptr)
    assert torch.equal(A.cols, D.cols) and torch.equal(A.vals, D.vals)
    for chunk in (1, 4, 16):
        R = bsg_from_csr(csr, layout="ragged", chunk=chunk, device="cpu")
        assert R.n_slots == A.n_slots
    G = bsg_from_coo([0, 1], [1, 0], [2.0, 3.0], 2, 2, device="cpu")
    assert G.layout == "dense"


def test_layout_arguments_are_checked():
    _mesh, sy = jax_problem(MESH_DIMS[1])
    csr = port_csr(sy)
    with pytest.raises(ValueError, match="layout"):
        bsg_from_csr(csr, layout="chunky", device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        bsg_from_csr(csr, layout="ragged", chunk=0, device="cpu")
