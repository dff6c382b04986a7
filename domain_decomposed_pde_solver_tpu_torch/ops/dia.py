"""DIA (diagonal) storage and the operator choice of the port.

Counterpart of the JAX package's ``ops/dia.py``.  Structured meshes (the
generated boxes behind the 1M/10M-DOF configurations, any lexicographically
numbered grid) give matrices whose nonzeros lie on a small fixed set of
diagonals, so a product is a sum of shifted elementwise multiplies:

    y[i] = sum_d  data[d, i] * x[i + offset_d]

On a CUDA tensor :meth:`DIAMatrix.matvec` launches the hand-written DIA
kernel (``csrc/dia_spmv.cu``, the port of ``ops/pallas/dia_kernel.py``);
on a CPU tensor it evaluates :func:`.dia_kernel.dia_matvec_plain`, JAX's
window-slice sum.  :func:`choose_operator` picks the format per matrix in
JAX's order: lattice stencil or pad-stencil (f32 with ``grid_dims``), then
DIA, then the sliced-ELL operator (:mod:`.bsg`), which also takes the
matrices JAX sends to Split-ELL or ELL (TPU gather-avoidance formats that a
GPU does not need).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .csr import CSRMatrix
from .ell import PaddedLayout, pad_to

__all__ = [
    "DIAMatrix",
    "choose_operator",
    "dia_from_csr",
    "operator_bytes",
    "pack_dia_host",
]

_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a numpy-style name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


@dataclasses.dataclass
class DIAMatrix(PaddedLayout):
    """Diagonal-storage sparse matrix.

    ``data[d, i]`` is the coefficient of ``x[i + offsets[d]]`` in row ``i``
    (zero where that column does not exist).  ``data`` may be stored
    narrower than the compute dtype (``compute_dtype`` non-empty, e.g.
    bfloat16 storage with float32 or float64 compute): every product
    upcasts the coefficient first.  :func:`dia_from_csr` selects narrow
    storage only when every entry is exactly representable, so results are
    bit-exact while the ``ndiags * n`` coefficient stream halves.
    """

    data: torch.Tensor  # (ndiags, n_pad), possibly narrow storage
    offsets: Tuple[int, ...]
    n_rows: int
    compute_dtype: str = ""  # "" -> data.dtype

    @property
    def n_pad(self) -> int:
        return int(self.data.shape[1])

    @property
    def n_cols(self) -> int:
        return self.n_rows

    @property
    def ndiags(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self) -> torch.dtype:
        """The compute/vector dtype (not the storage dtype of ``data``)."""
        if self.compute_dtype:
            return getattr(torch, self.compute_dtype)
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @functools.cached_property
    def offsets_array(self) -> np.ndarray:
        """The offsets as a contiguous host int64 array, built once: every
        kernel launch passes it as it is."""
        return np.ascontiguousarray(self.offsets, dtype=np.int64)

    def matvec(self, x_padded: torch.Tensor) -> torch.Tensor:
        """y = A @ x on padded vectors (kernel on CUDA, plain on the CPU)."""
        from .dia_kernel import dia_spmv

        return dia_spmv(self, x_padded)

    def diagonal_padded(self, fill: float = 1.0) -> torch.Tensor:
        if 0 in self.offsets:
            d = self.data[self.offsets.index(0)].to(self.dtype)
        else:
            d = torch.zeros(self.n_pad, dtype=self.dtype, device=self.device)
        pad = torch.arange(self.n_pad, device=self.device) >= self.n_rows
        return d.masked_fill((d == 0) | pad, fill)

    def astype(self, dtype) -> "DIAMatrix":
        """Materialize storage in ``dtype`` (drops any narrow storage)."""
        return DIAMatrix(self.data.to(_torch_dtype(dtype)), self.offsets,
                         self.n_rows)


def _bf16_exact(vals: np.ndarray) -> bool:
    """True iff every value survives a round trip through bfloat16.

    Graph-Laplacian entries (integer degrees and -1s) always do; AMG
    coarse and filtered operators generally do not, so they keep full
    storage.  Bit-level check: bfloat16 is float32 with the low 16 mantissa
    bits cut, so exactness means those bits are zero."""
    from ..utils.native import bf16_exact_native

    res = bf16_exact_native(vals)
    if res is not None:
        return res

    def _ok(chunk: np.ndarray) -> bool:
        f32 = np.ascontiguousarray(chunk, dtype=np.float32)
        if not np.array_equal(f32.astype(np.float64),
                              np.asarray(chunk, dtype=np.float64)):
            return False
        bits = f32.view(np.uint32)
        return bool(((bits & np.uint32(0xFFFF)) == 0).all())

    head = min(4096, vals.size)
    if not _ok(vals[:head]):
        return False
    return _ok(vals[head:]) if vals.size > head else True


def pack_dia_host(
    csr: CSRMatrix,
    dtype=torch.float32,
    max_diags: int = 64,
    row_multiple: int = 8,
):
    """Host-only DIA detect and pack: ``(offsets, data (ndiags, n_pad))``
    numpy arrays, or None when the matrix has more than ``max_diags``
    diagonals (or is not square).  Nothing is uploaded:
    :func:`choose_operator` runs stencil detection on this form first."""
    n = csr.n_rows
    if csr.n_cols != n:
        return None
    n_pad = pad_to(max(n, 1), row_multiple)
    np_dt = np.dtype(_NP[_torch_dtype(dtype)])
    if np_dt == np.float32:
        from ..utils.native import pack_dia_native

        packed = pack_dia_native(
            csr.indptr, csr.indices, csr.data, n, n_pad, max_diags
        )
        if packed == "toomany":
            return None
        if packed is not None:
            return packed
    rows = np.repeat(np.arange(n), csr.row_lengths())
    offs = csr.indices - rows
    uniq = np.unique(offs)
    if uniq.size > max_diags:
        return None
    data = np.zeros((uniq.size, n_pad), dtype=np_dt)
    dpos = np.searchsorted(uniq, offs)
    data[dpos, rows] = csr.data.astype(np_dt)
    return uniq, data


def _dia_wrap_device(csr, uniq, data, dtype, storage, device) -> DIAMatrix:
    dtype = _torch_dtype(dtype)
    compute = ""
    dev_data = torch.from_numpy(np.ascontiguousarray(data)).to(device)
    if (
        storage == "auto"
        and dtype.itemsize > 2
        and _bf16_exact(csr.data)
    ):
        dev_data = dev_data.to(torch.bfloat16)
        compute = str(dtype).replace("torch.", "")
    return DIAMatrix(
        data=dev_data,
        offsets=tuple(int(o) for o in uniq),
        n_rows=csr.n_rows,
        compute_dtype=compute,
    )


def dia_from_csr(
    csr: CSRMatrix,
    dtype=torch.float32,
    max_diags: int = 64,
    row_multiple: int = 8,
    storage: str = "auto",
    device=None,
) -> Optional[DIAMatrix]:
    """Convert to DIA iff every nonzero lies on at most ``max_diags``
    diagonals; returns None otherwise.

    ``storage="auto"`` stores the diagonals in bfloat16 when every entry is
    exactly representable there; ``"full"`` keeps storage == compute dtype.
    ``device`` defaults to the card."""
    packed = pack_dia_host(csr, dtype, max_diags, row_multiple)
    if packed is None:
        return None
    uniq, data = packed
    return _dia_wrap_device(csr, uniq, data, dtype, storage,
                            resolve_device(device))


def choose_operator(
    csr: CSRMatrix,
    dtype=torch.float32,
    max_diags: int = 64,
    bsg: str = "never",
    grid_dims=None,
    pad_stencil: str = "never",
    device=None,
):
    """Build the device operator for ``csr``, in JAX's branch order.

    - With ``grid_dims`` (a lexicographic (mx, my, mz) free-node grid) and
      f32, the lattice-stencil form when the matrix decomposes exactly:
      :class:`.stencil_kernel.PadStencilOperator` (padded 3-D space, the
      pad-stencil kernel) when ``pad_stencil`` is ``"always"``, or
      ``"auto"`` on a CUDA device (JAX's ``"auto"`` means a TPU);
      :class:`.stencil.StencilOperator` otherwise.
    - DIA when the diagonal count is at most ``max_diags``.
    - ``bsg="auto"`` or ``"always"``: the JAX BSG route as sliced ELL —
      RCM-permuted internal space, padded to a multiple of 1024 rows,
      float32 coefficients.  JAX takes it only for f32 on a TPU because its
      BSG computes in f32; the port's kernel also computes in f64, so the
      port takes it at either dtype.
    - Otherwise sliced ELL in the identity space, padded to 8 rows like
      JAX's ELL, with coefficients in ``dtype`` — where JAX takes Split-ELL
      or ELL.

    ``device`` defaults to the card.
    """
    if bsg not in ("never", "auto", "always"):
        raise ValueError(f"bsg must be never|auto|always, got {bsg!r}")
    if pad_stencil not in ("never", "auto", "always"):
        raise ValueError(
            f"pad_stencil must be never|auto|always, got {pad_stencil!r}"
        )
    dev = resolve_device(device)
    dtype = _torch_dtype(dtype)
    packed = pack_dia_host(csr, dtype=dtype, max_diags=max_diags)
    if packed is not None:
        uniq, data = packed
        if grid_dims is not None and dtype == torch.float32:
            from .stencil import stencil_from_parts, stencil_parts_from_packed

            parts = stencil_parts_from_packed(uniq, data, csr.n_rows,
                                              grid_dims)
            if parts is not None:
                if pad_stencil == "always" or (
                    pad_stencil == "auto" and dev.type == "cuda"
                ):
                    from .stencil_kernel import pad_stencil_from_parts

                    return pad_stencil_from_parts(parts, device=dev)
                return stencil_from_parts(parts, dtype=dtype, device=dev)
        return _dia_wrap_device(csr, uniq, data, dtype, "auto", dev)
    from .bsg import bsg_from_csr

    if bsg != "never":
        return bsg_from_csr(csr, device=dev)
    storage = "float64" if dtype == torch.float64 else "float32"
    return bsg_from_csr(csr, reorder=False, storage=storage, row_multiple=8,
                        device=dev)


def operator_bytes(A) -> int:
    """Compulsory device-memory traffic of one product with ``A``: every
    stored coefficient (or index and value) read once, ``x`` read once and
    ``y`` written once, in the vectors' compute dtype."""
    if isinstance(A, DIAMatrix):
        sb = A.data.element_size()  # storage (possibly bf16)
        vb = A.dtype.itemsize  # x/y vectors in compute dtype
        return A.ndiags * A.n_pad * sb + 2 * A.n_pad * vb
    from .stencil import StencilOperator

    if isinstance(A, StencilOperator):
        # x + y + corr: the patterns are scalars.
        return 3 * A.n_pad * A.dtype.itemsize
    from .stencil_kernel import PadStencilOperator

    if isinstance(A, PadStencilOperator):
        # x + y (f32) + corr (possibly bf16) in the padded 3-D space.
        return 2 * A.n_pad * 4 + A.n_pad * A.corr.element_size()
    from .bsg import BSGMatrix

    if isinstance(A, BSGMatrix):
        return (A.n_slots * (4 + A.vals.element_size())
                + A.x_len * 4 + A.n_pad * 4)
    raise TypeError(f"no byte count for {type(A).__name__}")
