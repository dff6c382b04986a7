"""Smoothed-aggregation algebraic multigrid (SA-AMG).

Counterpart of the JAX package's ``solvers/precond/amg.py``:

- the unstructured chain: a sliced-ELL fine operator (``fine_operator=``),
  greedy aggregation, Jacobi-smoothed prolongators in factored form,
  rectangular sliced-ELL tentative transfers ``G``/``GT`` above
  ``bsg_transfer_min_rows``, host-RCM-relabelled sliced-ELL mid levels
  above ``bsg_level_min_rows``;
- the structured route: on a lexicographic grid (``grid_dims``), level 0
  takes ``brick^3`` geometric aggregates with gather-free transfers
  (:class:`BrickProlongator` in the identity space,
  :class:`PadBrickProlongator` in a pad-stencil fine operator's padded 3-D
  space), and coarse levels with stencil structure become DIA operators;
- elsewhere explicit ELL ``P``/``R``, and a dense coarse inverse;
- ``level_info_out`` hands the raw per-level pieces (aggregates, counts,
  diagonal, lmax, omega) to the distributed hierarchy builder
  (``parallel/haloamg.py``), and ``operator_format="ell"`` with
  ``factored_transfers=False`` gives the uniform ELL levels of the
  block-Schwarz builder (``parallel/schwarz.py``).

- **Setup on host** (NumPy, scipy and the native library, run once): the
  same functions as the JAX package, so both build the same hierarchy.
- **Apply on device**: the V-cycle in PyTorch; every level operator goes
  through its own product (the sliced-ELL, DIA and pad-stencil kernels on
  the card).  The selection gather of :class:`FactoredProlongator` is
  ``index_select``, its segment sum sliced-ELL operators on kernel 1
  (``ops.bsg.segment_sum_operator``: a fixed order, where ``index_add_``
  adds with atomics on the card); the brick transfers are reshapes,
  repeats and block sums.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ...ops.bsg import (
    TILE,
    BSGMatrix,
    SegmentSum,
    bsg_from_coo,
    bsg_from_csr,
    segment_sum_operator,
)
from ...ops.csr import CSRMatrix
from ...ops.dia import DIAMatrix, choose_operator
from ...ops.ell import ELLMatrix, ell_from_csr, pad_to
from ...ops.stencil import StencilOperator
from ...ops.stencil_kernel import PadStencilOperator
from ...utils.device import resolve_device
from ...utils.timers import record, spanned
from .cheby import chebyshev_smooth

__all__ = [
    "AMGLevel",
    "AMGPreconditioner",
    "BSGTransferProlongator",
    "BrickProlongator",
    "FactoredProlongator",
    "FactoredRestriction",
    "PadBrickProlongator",
    "aggregate_greedy",
    "brick_aggregate",
    "infer_free_grid",
    "smoothed_aggregation_preconditioner",
    "smoothed_aggregation_setup",
]

# ---------------------------------------------------------------------------
# Host-side setup (identical to the JAX package)
# ---------------------------------------------------------------------------


def _to_scipy(A: CSRMatrix):
    """Zero-copy scipy view of a canonical CSRMatrix (READ-ONLY use).

    The tuple constructor unifies index dtypes by copying data + indices
    (~160 MB at 1M DOF).  Assembly already emits canonical sorted CSR, so
    validation is skipped and the arrays are shared; only indptr is cast to
    the index dtype (n_rows * 4 bytes).  Callers must not mutate the result
    in place."""
    import scipy.sparse as sp

    nnz = int(A.indptr[-1])
    if A.indices.dtype == np.int32 and nnz <= np.iinfo(np.int32).max:
        idx_t = np.int32
        indices = A.indices
    else:
        idx_t = np.int64
        indices = (
            A.indices
            if A.indices.dtype == np.int64
            else A.indices.astype(np.int64)
        )
    indptr = A.indptr if A.indptr.dtype == idx_t else A.indptr.astype(idx_t)
    S = sp.csr_matrix(A.shape, dtype=A.data.dtype)
    S.data, S.indices, S.indptr = A.data, indices, indptr
    return S


def _from_scipy(S) -> CSRMatrix:
    S = S.tocsr()
    S.sort_indices()
    return CSRMatrix(
        indptr=S.indptr.astype(np.int64),
        indices=S.indices.astype(np.int64),
        data=S.data.astype(np.float64),
        shape=S.shape,
    )


def aggregate_greedy(A: CSRMatrix, theta: float = 0.0) -> np.ndarray:
    """Standard greedy aggregation on the strength graph.

    Returns ``agg[i]`` = aggregate id per node.  Three passes (Vanek et al.):
    root aggregates over fully-free neighborhoods, attachment of leftovers to
    adjacent aggregates, then singleton/new aggregates for stragglers.
    ``theta`` filters weak couplings |a_ij| < theta*sqrt(a_ii a_jj).
    """
    n = A.n_rows
    indptr, indices, data = A.indptr, A.indices, A.data
    diag = A.diagonal()

    # Native fast path: strength filter applied inline in C++ — no
    # materialized filtered graph (the numpy repeat/mask/bincount/gather
    # preamble alone cost ~5 s of the 6.35 s aggregation at 3.2M rows).
    from ...utils.native import aggregate_greedy_filtered_native

    res = aggregate_greedy_filtered_native(
        indptr, indices, data, diag, theta, n
    )
    if res is not None:
        return res[0]

    agg = np.full(n, -1, dtype=np.int64)
    # Strength filter mask per nonzero.
    rows = np.repeat(np.arange(n), np.diff(indptr))
    strong = (rows != indices) & (
        np.abs(data) >= theta * np.sqrt(np.abs(diag[rows] * diag[indices]) + 1e-300)
    )

    # Pass 1: roots with entirely unaggregated strong neighborhoods.
    next_agg = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        lo, hi = indptr[i], indptr[i + 1]
        nbrs = indices[lo:hi][strong[lo:hi]]
        if (agg[nbrs] == -1).all():
            agg[i] = next_agg
            agg[nbrs] = next_agg
            next_agg += 1
    # Pass 2: attach leftovers to a neighboring aggregate.
    for i in range(n):
        if agg[i] != -1:
            continue
        lo, hi = indptr[i], indptr[i + 1]
        nbrs = indices[lo:hi][strong[lo:hi]]
        assigned = nbrs[agg[nbrs] != -1]
        if assigned.size:
            agg[i] = agg[assigned[0]]
    # Pass 3: new aggregates for isolated stragglers.
    for i in range(n):
        if agg[i] == -1:
            agg[i] = next_agg
            next_agg += 1
    return agg


def _filter_weak_entries(S, tol: float):
    """Drop off-diagonal |a_ij| < tol*sqrt(a_ii a_jj), lumping the dropped
    values into the diagonal (row sums preserved)."""
    import scipy.sparse as sp

    S = S.tocoo()
    d = np.abs(S.tocsr().diagonal())
    d = np.where(d != 0, d, 1.0)
    weak = (S.row != S.col) & (
        np.abs(S.data) < tol * np.sqrt(d[S.row] * d[S.col])
    )
    lump = np.zeros(S.shape[0])
    np.add.at(lump, S.row[weak], S.data[weak])
    keep = ~weak
    out = sp.csr_matrix(
        (S.data[keep], (S.row[keep], S.col[keep])), shape=S.shape
    )
    out = out + sp.diags(lump)
    out.sum_duplicates()
    return out.tocsr()


def _lmax_dinv_a_host(S) -> float:
    """Power-method estimate of lambda_max(D^-1 A) on the host CSR.

    D^-1 A is applied as matvec-then-divide (no ``Dinv @ S`` spgemm).
    Above 1.5M rows the matrix is recast to f32 values + int32 indices
    first (half the memory traffic of the 20 power matvecs), gated so small
    hierarchies stay bit-identical.  The JAX package's own function, which
    this one copies, records why the power estimate is kept over the
    Gershgorin bound (2.0): the bound overshoots the top of the spectrum of
    tet meshes, shrinking omega/lmax and lifting the Chebyshev interval off
    the true spectrum, which costs CG+AMG iterations."""
    if S.shape[0] > 1_500_000 and S.nnz < 2**31:
        import scipy.sparse as sp

        S = sp.csr_matrix(
            (
                S.data.astype(np.float32),
                S.indices.astype(np.int32),
                S.indptr.astype(np.int32),
            ),
            shape=S.shape,
        )
    d = S.diagonal()
    d = np.where(d != 0, d, 1.0)
    rng = np.random.default_rng(0)
    q = rng.uniform(size=S.shape[0])
    q /= np.linalg.norm(q)
    q = q.astype(S.dtype, copy=False)  # f64 q would upcast the matvec
    lam = 1.0
    for _ in range(20):
        z = (S @ q) / d  # one matvec per iteration: lam = q.z with unit q
        nz = np.linalg.norm(z)  # is the same Rayleigh estimate the old
        if nz == 0:  # two-matvec form computed, at half the cost
            return 1.0
        lam = q @ z
        q = z / nz
    # 5% safety factor: the power method underestimates lambda_max when the
    # top eigenvalues cluster (measured 6-8% short at 20^3 boxes with few
    # iterations); containment matters more than a slightly tighter
    # Chebyshev interval.
    return float(abs(lam)) * 1.05


def _pad_brick_level0_device(A_op, brick: int, omega: float, lmax: float,
                             dtype):
    """Level-0 transfer and smoother vectors computed on the device in a
    pad-stencil operator's padded 3-D space, with no n-sized upload.

    - ``tval[i] = 1/sqrt(|aggregate of i|)`` with clamped ``brick^3``
      aggregates: the aggregate size is a product of per-axis clamped
      extents, so it is an outer product of three small axis vectors;
    - ``scale = (omega/lmax) / diag`` and ``inv_diag = 1/diag`` from the
      operator's own ``diagonal_padded``.

    ``tval`` must be 0 on pads, and is; ``scale`` is 0 and ``inv_diag`` 1
    there, as in the levels built from host arrays (they multiply vectors
    that are 0 there)."""
    mx, my, mz = A_op.dims
    dev = A_op.device

    def axis_counts(m, n_pad, lead):
        v = np.zeros(n_pad, np.float32)
        a = np.arange(m) // brick
        v[lead : lead + m] = np.minimum(brick, m - a * brick)
        return torch.from_numpy(v).to(dev)

    counts3 = (
        axis_counts(mz, A_op.Z, 1)[:, None, None]
        * axis_counts(my, A_op.myp, 1)[None, :, None]
        * axis_counts(mx, A_op.mxp, 0)[None, None, :]
    )
    tval = torch.where(
        counts3 > 0, 1.0 / torch.sqrt(counts3.clamp_min(1.0)),
        torch.zeros_like(counts3),
    ).reshape(-1).to(dtype)
    dpad = A_op.diagonal_padded(fill=1.0).to(dtype)
    scale = torch.where(tval > 0, (omega / lmax) / dpad,
                        torch.zeros_like(dpad))
    inv_d = 1.0 / dpad
    return tval, scale, inv_d


def _count_diagonals_capped(csr, cap: int) -> int:
    """Number of distinct diagonals, early-exiting once > ``cap``.

    Replaces ``np.unique(indices - rows)`` whose nnz-sized sort cost
    seconds at 10M DOF; one chunked pass over a (2n+1)-slot bitmap."""
    n = csr.n_rows
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    seen = np.zeros(2 * n + 1, dtype=bool)
    step = max(1, n // 16)
    count = 0
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        lo, hi = int(indptr[r0]), int(indptr[r1])
        rows_c = np.repeat(
            np.arange(r0, r1, dtype=np.int64), np.diff(indptr[r0 : r1 + 1])
        )
        seen[indices[lo:hi] - rows_c + n] = True
        count = int(seen.sum())
        if count > cap:
            return count
    return count


def infer_free_grid(mesh, free_to_node) -> Optional[Tuple[int, int, int]]:
    """Detect a lexicographic free-node grid: returns (mx, my, mz) with
    free index == ix + mx*(iy + my*iz), or None for unstructured meshes.

    Host-side check over coordinate ranks (generated box meshes number
    nodes x-fastest and Dirichlet elimination preserves order, so free
    nodes of a box form exactly such a grid)."""
    c = np.asarray(mesh.coords)[np.asarray(free_to_node)]
    if c.shape[1] != 3:
        return None
    n = c.shape[0]
    ux, uy, uz = (np.unique(c[:, k]) for k in range(3))
    if ux.size * uy.size * uz.size != n:
        return None
    ix = np.searchsorted(ux, c[:, 0])
    iy = np.searchsorted(uy, c[:, 1])
    iz = np.searchsorted(uz, c[:, 2])
    mx, my = ux.size, uy.size
    if not np.array_equal(ix + mx * (iy + my * iz), np.arange(n)):
        return None
    return (int(ux.size), int(uy.size), int(uz.size))


def brick_aggregate(dims: Tuple[int, int, int], brick: int) -> np.ndarray:
    """Aggregate id of every node of a lexicographic (mx, my, mz) grid for
    ``brick^3`` bricks (clamped at the far edges)."""
    mx, my, mz = dims
    b = brick
    ncx, ncy = -(-mx // b), -(-my // b)
    ax = np.arange(mx, dtype=np.int64) // b
    ay = ncx * (np.arange(my, dtype=np.int64) // b)
    az = (ncx * ncy) * (np.arange(mz, dtype=np.int64) // b)
    return (
        az[:, None, None] + ay[None, :, None] + ax[None, None, :]
    ).reshape(-1)


# ---------------------------------------------------------------------------
# Device-side transfer operators and the V-cycle
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FactoredProlongator:
    """Smoothed prolongator ``P = (I - (omega/lmax) D^-1 A) T`` applied in
    factored form: one selection gather plus a fine-level matvec; ``R = P^T``
    through symmetry: ``R r = T^T (r - omega D^-1 A r)``.  ``T^T``'s
    segment sum is ``ST`` (:func:`..ops.bsg.segment_sum_operator` over the
    real fine rows, built from ``agg`` and ``tval`` when not given): each
    aggregate's rows added in ascending order, in pieces where it is wide,
    the same bits on every run."""

    agg: torch.Tensor  # (n_pad_f,) int64 aggregate per fine row (0 on padding)
    tval: torch.Tensor  # (n_pad_f,) tentative weight (0 on padding)
    scale: torch.Tensor  # (n_pad_f,) omega/lmax * 1/diag (0 on padding)
    A: object  # fine-level operator with .matvec
    n_pad_c: int
    ST: Optional[SegmentSum] = None  # (n_pad_c x n_pad_f) segment sum

    def __post_init__(self):
        if self.ST is None:
            self.ST = segment_sum_operator(
                self.agg.cpu().numpy(), self.n_pad_c,
                valid=(self.tval != 0).cpu().numpy(), device=self.agg.device)

    def matvec(self, x_c: torch.Tensor) -> torch.Tensor:
        t = self.tval * x_c.index_select(0, self.agg)
        return t - self.scale * self.A.matvec(t)

    def rmatvec(self, r: torch.Tensor) -> torch.Tensor:
        s = r - self.A.matvec(self.scale * r)
        return self.ST.matvec(self.tval * s)


@dataclasses.dataclass
class BSGTransferProlongator:
    """Factored smoothed prolongator whose tentative transfers are
    rectangular sliced-ELL operators: ``G`` holds T with tval folded in
    (fine internal rows x coarse cols), ``GT`` its transpose."""

    G: BSGMatrix
    GT: BSGMatrix
    scale: torch.Tensor
    A: object
    n_pad_c: int

    def matvec(self, x_c: torch.Tensor) -> torch.Tensor:
        t = self.G.matvec(x_c)
        return t - self.scale * self.A.matvec(t)

    def rmatvec(self, r: torch.Tensor) -> torch.Tensor:
        s = r - self.A.matvec(self.scale * r)
        return self.GT.matvec(s)[: self.n_pad_c]


def _build_bsg_transfers(agg, counts, rows_int, n_c, n_pad_f, n_pad_c,
                         device=None):
    """Pack T (tval folded in) and T^T as rectangular sliced-ELL operators
    with float32 values, as the JAX package packs them (``storage=
    "float32"``).  ``rows_int``: internal row per original fine row;
    ``agg``/``counts`` in the first-appearance coarse numbering."""
    tval = (1.0 / np.sqrt(counts))[agg]
    G = bsg_from_coo(rows_int, agg, tval, n_pad_f, n_pad_c,
                     storage="float32", device=device)
    GT = bsg_from_coo(agg, rows_int, tval, n_c, n_pad_f,
                      storage="float32", device=device)
    return G, GT


@dataclasses.dataclass
class FactoredRestriction:
    """R = P^T for a factored prolongator (shares its arrays)."""

    P: object

    def matvec(self, r: torch.Tensor) -> torch.Tensor:
        return self.P.rmatvec(r)


def _brick_expand(x_c, dims, brick):
    """T's selection for bricks: coarse (ncz, ncy, ncx) values repeated
    ``brick`` times along each axis, cut to the (mz, my, mx) grid."""
    mx, my, mz = dims
    b = brick
    ncx, ncy, ncz = -(-mx // b), -(-my // b), -(-mz // b)
    z = x_c[: ncx * ncy * ncz].reshape(ncz, ncy, ncx)
    z = z.repeat_interleave(b, dim=0)[:mz]
    z = z.repeat_interleave(b, dim=1)[:, :my]
    return z.repeat_interleave(b, dim=2)[:, :, :mx]


def _brick_sum(tw, dims, brick, n_pad_c):
    """T^T's segment sum for bricks: block sums of a (mz, my, mx) field,
    flattened and zero-padded to ``n_pad_c``."""
    mx, my, mz = dims
    b = brick
    ncx, ncy, ncz = -(-mx // b), -(-my // b), -(-mz // b)
    tw = torch.nn.functional.pad(
        tw, (0, ncx * b - mx, 0, ncy * b - my, 0, ncz * b - mz)
    )
    c = tw.reshape(ncz, b, ncy, b, ncx, b).sum(dim=(1, 3, 5)).reshape(-1)
    return torch.nn.functional.pad(c, (0, n_pad_c - ncx * ncy * ncz))


@dataclasses.dataclass
class BrickProlongator:
    """Gather-free factored prolongator for lexicographic grids: the
    aggregate of a node is its ``brick^3`` brick, so ``T x_c`` is a repeat
    and ``T^T w`` a block sum.  ``dims = (mx, my, mz)`` with fine index
    ``ix + mx*(iy + my*iz)``; vectors in the identity padded space."""

    tval: torch.Tensor  # (n_pad_f,) tentative weight (0 on padding)
    scale: torch.Tensor  # (n_pad_f,) omega/lmax * 1/diag (0 on padding)
    A: object  # fine-level operator
    dims: Tuple[int, int, int]
    brick: int
    n_pad_c: int
    n_pad_f: int

    def _t_apply(self, x_c: torch.Tensor) -> torch.Tensor:
        mx, my, mz = self.dims
        flat = _brick_expand(x_c, self.dims, self.brick).reshape(-1)
        flat = torch.nn.functional.pad(flat, (0, self.n_pad_f - mx * my * mz))
        return self.tval * flat

    def _t_transpose(self, w: torch.Tensor) -> torch.Tensor:
        mx, my, mz = self.dims
        tw = (self.tval * w)[: mx * my * mz].reshape(mz, my, mx)
        return _brick_sum(tw, self.dims, self.brick, self.n_pad_c)

    def matvec(self, x_c: torch.Tensor) -> torch.Tensor:
        t = self._t_apply(x_c)
        return t - self.scale * self.A.matvec(t)

    def rmatvec(self, r: torch.Tensor) -> torch.Tensor:
        s = r - self.A.matvec(self.scale * r)
        return self._t_transpose(s)


@dataclasses.dataclass
class PadBrickProlongator:
    """:class:`BrickProlongator`'s algebra in a pad-stencil operator's
    padded 3-D space ``(Z, myp, mxp)`` (grid interior at
    ``[1:mz+1, 1:my+1, :mx]``): ``tval``/``scale`` live in that space, and
    the tentative transfer embeds and extracts the interior with static
    pads and slices."""

    tval: torch.Tensor  # (n_space,) tentative weight, 0 on pad slots
    scale: torch.Tensor  # (n_space,) omega/lmax * 1/diag
    A: PadStencilOperator  # fine-level operator
    dims: Tuple[int, int, int]
    brick: int
    n_pad_c: int

    def _t_apply(self, x_c: torch.Tensor) -> torch.Tensor:
        z = _brick_expand(x_c, self.dims, self.brick)
        return self.tval * self.A.embed_device(z.reshape(-1))

    def _t_transpose(self, w: torch.Tensor) -> torch.Tensor:
        mx, my, mz = self.dims
        tw = self.A.extract_device(self.tval * w).reshape(mz, my, mx)
        return _brick_sum(tw, self.dims, self.brick, self.n_pad_c)

    def matvec(self, x_c: torch.Tensor) -> torch.Tensor:
        t = self._t_apply(x_c)
        return t - self.scale * self.A.matvec(t)

    def rmatvec(self, r: torch.Tensor) -> torch.Tensor:
        s = r - self.A.matvec(self.scale * r)
        return self._t_transpose(s)


@dataclasses.dataclass
class AMGLevel:
    A: object  # level operator (padded), .matvec
    P: object  # prolongation: coarse -> this level
    R: object  # restriction: this level -> coarse
    inv_diag: torch.Tensor  # 1/diag(A), padded with 1
    lmax: torch.Tensor  # 0-d CPU tensor: lambda_max(D^-1 A)
    n_rows: int


@dataclasses.dataclass
class AMGPreconditioner:
    """``cycles`` V-cycles per apply, each level smoothed by Chebyshev
    (JAX's default) or damped Jacobi: JAX's algebra
    (``solvers/precond/amg.py:616-639`` there)."""

    levels: List[AMGLevel]
    coarse_inv: torch.Tensor  # dense inverse of the coarsest operator (padded)
    smoother: str = "chebyshev"  # "chebyshev" | "jacobi"
    smooth_steps: int = 2
    cycles: int = 1  # V-cycles per apply

    @property
    def num_levels(self) -> int:
        return len(self.levels) + 1

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        x = self._vcycle(0, r)
        for _ in range(self.cycles - 1):
            x = x + self._vcycle(0, r - self.levels[0].A.matvec(x))
        return x

    def _smooth(self, lvl: AMGLevel, x, b, x_zero: bool = False):
        # x_zero: the pre-smooth starts from x = 0, so its first residual
        # is b and one product per level per cycle is skipped.
        if self.smoother == "jacobi":
            omega = 2.0 / 3.0
            for i in range(self.smooth_steps):
                r = b if (x_zero and i == 0) else b - lvl.A.matvec(x)
                x = x + omega * lvl.inv_diag * r
            return x
        return chebyshev_smooth(
            lvl.A.matvec, lvl.inv_diag, lvl.lmax, self.smooth_steps, x, b,
            x_zero=x_zero,
        )

    def _vcycle(self, k: int, b: torch.Tensor) -> torch.Tensor:
        if k == len(self.levels):
            if self.coarse_inv.dim() == 1:  # diagonal fallback (stalled agg)
                return self.coarse_inv * b
            # TF32 is off here: this is a matrix-vector product (cuBLAS
            # gemv, which has no TF32 path), and torch.mv keeps full
            # float32 / float64 precision.
            return torch.mv(self.coarse_inv, b)
        lvl = self.levels[k]
        x = self._smooth(lvl, torch.zeros_like(b), b, x_zero=True)
        r_c = lvl.R.matvec(b - lvl.A.matvec(x))
        x_c = self._vcycle(k + 1, r_c)
        x = x + lvl.P.matvec(x_c)
        return self._smooth(lvl, x, b)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _inv_diag_padded(A: CSRMatrix, n_pad: int, dtype, device) -> torch.Tensor:
    d = A.diagonal()
    d = np.where(d != 0, d, 1.0)
    out = np.ones(n_pad, dtype=_np_dtype(dtype))
    out[: d.size] = (1.0 / d).astype(_np_dtype(dtype))
    return _to_device(out, device)


def _np_dtype(dtype) -> np.dtype:
    return np.dtype(str(dtype).replace("torch.", ""))


@spanned("setup.amg")
def smoothed_aggregation_setup(
    A: CSRMatrix,
    dtype=torch.float32,
    theta: float = 0.0,
    omega: float = 4.0 / 3.0,
    max_levels: int = 10,
    coarse_size: int = 64,
    smoother: str = "chebyshev",
    smooth_steps: int = 2,
    factored_transfers: bool = True,
    filter_tol: Union[float, str] = "auto",
    operator_format: str = "auto",
    aggressive_levels: Union[int, str] = "auto",
    grid_dims: Optional[Tuple[int, int, int]] = None,
    brick: int = 6,
    fine_operator=None,
    level_info_out: Optional[list] = None,
    timings_out: Optional[dict] = None,
    bsg_mid_levels: bool = True,
    bsg_level_min_rows: int = 100_000,
    bsg_transfers: bool = True,
    bsg_transfer_min_rows: int = 200_000,
    device=None,
) -> AMGPreconditioner:
    """Build the SA-AMG hierarchy from the host CSR operator.

    The same hierarchy as the JAX function, with JAX's parameters in its
    order, plus ``device`` (default: the fine operator's device, else the
    card).

    - ``smoother``: ``"chebyshev"`` (default) or ``"jacobi"`` (damped,
      omega = 2/3, ``smooth_steps`` sweeps) on every level.  The number
      of V-cycles per apply is the preconditioner's ``cycles`` field
      (1 here; JAX's set-up takes no such keyword either).

    - ``fine_operator``: a prebuilt level-0 operator that owns its vector
      space — a sliced-ELL :class:`BSGMatrix` (possibly RCM-permuted) or a
      :class:`PadStencilOperator` (padded 3-D space).  The fine level of
      the V-cycle then lives in that space, and the caller's CG must use
      the same operator.  Other operator types are ignored, as in JAX.
    - With a sliced-ELL fine operator (the BSG chain), coarse levels above
      ``bsg_level_min_rows`` rows are sliced-ELL operators in a
      host-RCM-relabelled identity space, and transfers of levels with at
      least ``bsg_transfer_min_rows`` rows are rectangular sliced-ELL
      ``G``/``GT``.  ``bsg_mid_levels=False`` opts out of the chain: the
      coarse levels are built as over any other fine level (no host
      relabel; sliced ELL in the identity space with explicit ELL
      transfers, where JAX takes Split-ELL or ELL), and a fine level of
      more than 200,000 rows then composes two aggregation rounds
      (``aggressive_levels="auto"``).  ``bsg_transfers=False`` keeps the
      chain's levels with factored transfers.
    - ``grid_dims``: a lexicographic free-node grid matching ``A``; level 0
      then takes ``brick^3`` aggregates and gather-free brick transfers.
    - ``filter_tol="auto"`` is 0.005 on the BSG chain, 0.01 otherwise;
      ``aggressive_levels="auto"`` follows JAX's rule.
    - ``level_info_out``: a list that receives, per level, a dict of the
      raw setup pieces (``n``, ``agg``, ``counts``, ``d``, ``lmax``,
      ``omega``) for the distributed builders.  As in JAX, it turns the
      BSG chain off, so the coarse levels keep the raw aggregate numbering
      (no host relabelling) that those builders index.
    - ``operator_format="ell"``: every level built here is a plain ELL
      operator (no DIA, no sliced ELL); ``factored_transfers=False``: DIA
      and stencil levels take explicit ELL ``P``/``R``.  The block-Schwarz
      builder asks for both, as JAX's does.
    """
    import scipy.sparse as sp

    if operator_format not in ("auto", "ell"):
        raise ValueError(
            f"operator_format must be auto|ell, got {operator_format!r}")
    _tm = {} if timings_out is None else timings_out
    _last = [time.time_ns()]

    def _mark(name):
        # The phase since the last mark: a child span of setup.amg, whose
        # seconds timings_out sums by phase.
        now = time.time_ns()
        s = record(f"setup.amg.{name}", _last[0], now)
        _tm[name] = _tm.get(name, 0.0) + s.seconds
        _last[0] = now

    use_fine_op = isinstance(fine_operator, (BSGMatrix, PadStencilOperator))
    if device is None and use_fine_op:
        device = fine_operator.device
    device = resolve_device(device)
    np_dt = _np_dtype(dtype)

    levels: List[AMGLevel] = []
    A_k = _to_scipy(A)
    if use_fine_op and fine_operator.n_rows != A.n_rows:
        raise ValueError("fine_operator does not match A")
    n_pads = [fine_operator.n_pad if use_fine_op else pad_to(max(A.n_rows, 1))]
    # The BSG chain starts at a sliced-ELL fine operator; the distributed
    # builders (level_info_out) take the raw hierarchy without it.
    fine_sell = use_fine_op and isinstance(fine_operator, BSGMatrix)
    bsg_chain = bsg_mid_levels and fine_sell and level_info_out is None
    grid_match = grid_dims is not None and int(np.prod(grid_dims)) == A.n_rows

    if aggressive_levels == "auto":
        if grid_match:
            # Brick transfers replace level-0 greedy aggregation, and the
            # aggressive compose only ever applies at level 0.
            aggressive_levels = 0
        elif fine_sell and A.n_rows > 200_000:
            # Without the chain's sliced-ELL mid levels, JAX skips the
            # several-100k-row level 1 by composing two aggregation rounds.
            aggressive_levels = 0 if bsg_chain else 1
        elif operator_format != "ell" and A.n_rows > 200_000:
            ndiags = _count_diagonals_capped(A, 64)
            aggressive_levels = 1 if ndiags <= 64 else 0
        else:
            aggressive_levels = 0
    _mark("diag_probe")

    if filter_tol == "auto":
        filter_tol = 0.005 if bsg_chain else 0.01
    mid_bsg = False  # this level is a chain level (host-RCM identity space)
    while A_k.shape[0] > coarse_size and len(levels) < max_levels - 1:
        csr_k = A if len(levels) == 0 else _from_scipy(A_k)
        this_bsg = bsg_chain if len(levels) == 0 else mid_bsg
        if len(levels) == 0 and grid_dims is not None and not grid_match:
            import warnings

            warnings.warn(
                f"grid_dims {tuple(grid_dims)} does not match the operator "
                f"size {A_k.shape[0]}; falling back to greedy aggregation "
                f"(gathered transfers)",
                stacklevel=2,
            )
        use_brick = len(levels) == 0 and grid_match
        if use_brick:
            agg = brick_aggregate(grid_dims, brick)
        else:
            agg = aggregate_greedy(csr_k, theta=theta)
            if len(levels) < aggressive_levels:
                n_c1 = int(agg.max()) + 1 if agg.size else 0
                if 0 < n_c1 < A_k.shape[0]:
                    # Second round on the (unsmoothed) aggregate graph;
                    # compose.
                    from ...utils.native import rap_galerkin_native

                    T1 = sp.csr_matrix(
                        (np.ones(A_k.shape[0]),
                         (np.arange(A_k.shape[0]), agg)),
                        shape=(A_k.shape[0], n_c1),
                    )
                    T1.sort_indices()
                    g = rap_galerkin_native(
                        A_k.indptr, A_k.indices, A_k.data,
                        T1.indptr, T1.indices, T1.data,
                        A_k.shape[0], n_c1,
                    )
                    if g is not None:
                        G = sp.csr_matrix((g[2], g[1], g[0]),
                                          shape=(n_c1, n_c1))
                    else:
                        G = (T1.T @ A_k @ T1).tocsr()
                    G.sum_duplicates()
                    agg2 = aggregate_greedy(_from_scipy(G), theta=theta)
                    agg = agg2[agg]
        n_c = int(agg.max()) + 1 if agg.size else 0
        _mark("aggregate")
        if n_c >= A_k.shape[0] or n_c == 0:
            break  # aggregation stalled
        coarse_bsg = this_bsg and n_c > bsg_level_min_rows
        bsg_tx_level = (bsg_transfers and this_bsg
                        and A_k.shape[0] >= bsg_transfer_min_rows)
        counts = np.bincount(agg, minlength=n_c).astype(np.float64)
        d = A_k.diagonal()
        d = np.where(d != 0, d, 1.0)
        lmax = _lmax_dinv_a_host(A_k)
        _mark("lmax")
        if level_info_out is not None:
            level_info_out.append(dict(
                n=A_k.shape[0], agg=agg.copy(), counts=counts.copy(),
                d=d.copy(), lmax=float(lmax), omega=float(omega),
            ))
        from ...utils.native import rap_galerkin_native, sa_prolongator_native

        tval = 1.0 / np.sqrt(counts)
        ps = sa_prolongator_native(
            A_k.indptr, A_k.indices, A_k.data, agg, tval,
            (omega / lmax) / d, A_k.shape[0], n_c,
        )
        if ps is not None:
            Pp, Pi, Px = ps
            P = None
        else:
            T = sp.csr_matrix(
                (tval[agg], (np.arange(A_k.shape[0]), agg)),
                shape=(A_k.shape[0], n_c),
            )
            Dinv = sp.diags(1.0 / d)
            P = (T - (omega / lmax) * (Dinv @ (A_k @ T))).tocsr()
            P.sort_indices()
            Pp, Pi, Px = P.indptr, P.indices, P.data
        _mark("prolongator")
        rap = rap_galerkin_native(
            A_k.indptr, A_k.indices, A_k.data, Pp, Pi, Px, A_k.shape[0], n_c,
        )
        if rap is not None:
            Cp, Ci, Cx = rap
            A_c = sp.csr_matrix((Cx, Ci, Cp), shape=(n_c, n_c))
        else:
            if P is None:
                P = sp.csr_matrix((Px, Pi, Pp), shape=(A_k.shape[0], n_c))
            A_c = (P.T.tocsr() @ (A_k @ P)).tocsr()
        A_c.sum_duplicates()
        if filter_tol > 0:
            A_c = _filter_weak_entries(A_c, filter_tol)
        if coarse_bsg or bsg_tx_level:
            # Relabel the coarse space (JAX amg.py:968-1006): by first
            # appearance along the fine internal order when this level's
            # transfers are sliced-ELL G/GT, else by coarse-graph RCM.
            if bsg_tx_level:
                if len(levels) == 0 and fine_operator.perm is not None:
                    seq = agg[np.argsort(fine_operator.perm.cpu().numpy())]
                else:
                    seq = agg
                u, first = np.unique(seq, return_index=True)
                order_c = u[np.argsort(first)].astype(np.int64)
            else:
                from scipy.sparse.csgraph import reverse_cuthill_mckee

                order_c = np.asarray(
                    reverse_cuthill_mckee(A_c, symmetric_mode=True)
                ).astype(np.int64)
            perm_c = np.empty(n_c, dtype=np.int64)
            perm_c[order_c] = np.arange(n_c, dtype=np.int64)
            A_c = A_c[order_c][:, order_c].tocsr()
            A_c.sort_indices()
            agg = perm_c[agg]
            counts = counts[order_c]
        _mark("rap")

        n_pad_f = n_pads[-1]
        n_pad_c = (-(-max(n_c, 1) // TILE) * TILE if coarse_bsg
                   else pad_to(max(n_c, 1)))
        fine_op = use_fine_op and len(levels) == 0
        if fine_op:
            lvl_A = fine_operator
        elif this_bsg:
            # Chain level: csr_k is already in this level's (host-RCM)
            # order, so the operator's internal space is the identity.
            lvl_A = bsg_from_csr(csr_k, reorder=False, device=device)
        elif operator_format == "ell":
            lvl_A = ell_from_csr(csr_k, dtype=dtype,
                                 device=device).repad(n_pad_f)
        else:
            lvl_A = choose_operator(
                csr_k, dtype=dtype,
                grid_dims=grid_dims if len(levels) == 0 else None,
                device=device,
            )
        if lvl_A.n_pad != n_pad_f:
            raise AssertionError((lvl_A.n_pad, n_pad_f))
        _mark("level_op")

        n_f = A_k.shape[0]
        if fine_op:
            # The fine level lives in the operator's own (permuted or
            # embedded) space.  Brick vectors of a pad-stencil level are
            # built there on the device; other levels scatter the per-row
            # arrays through the space map.  Pad slots keep tval = 0.
            pad_brick = isinstance(fine_operator, PadStencilOperator) and use_brick
            if pad_brick:
                tval_dev, scale_dev, inv_diag = _pad_brick_level0_device(
                    fine_operator, brick, omega, lmax, dtype
                )
            else:
                if isinstance(fine_operator, PadStencilOperator):
                    perm = fine_operator.space_map()
                elif fine_operator.perm is not None:
                    perm = fine_operator.perm.cpu().numpy()
                else:
                    perm = np.arange(n_f, dtype=np.int64)
                tval_pad = np.zeros(n_pad_f, dtype=np_dt)
                tval_pad[perm] = 1.0 / np.sqrt(counts[agg])
                scale_pad = np.zeros(n_pad_f, dtype=np_dt)
                scale_pad[perm] = (omega / lmax) / d
                inv_d = np.ones(n_pad_f, dtype=np_dt)
                inv_d[perm] = (1.0 / d).astype(np_dt)
                tval_dev = _to_device(tval_pad, device)
                scale_dev = _to_device(scale_pad, device)
                inv_diag = _to_device(inv_d, device)
            if pad_brick:
                P_op = PadBrickProlongator(
                    tval=tval_dev, scale=scale_dev, A=lvl_A,
                    dims=tuple(int(v) for v in grid_dims), brick=brick,
                    n_pad_c=n_pad_c,
                )
            elif bsg_tx_level:
                G, GT = _build_bsg_transfers(
                    agg, counts, perm[:n_f], n_c, n_pad_f, n_pad_c, device
                )
                P_op = BSGTransferProlongator(
                    G=G, GT=GT, scale=scale_dev, A=lvl_A, n_pad_c=n_pad_c
                )
            else:
                agg_pad = np.zeros(n_pad_f, dtype=np.int64)
                agg_pad[perm] = agg
                P_op = FactoredProlongator(
                    agg=_to_device(agg_pad, device), tval=tval_dev,
                    scale=scale_dev, A=lvl_A, n_pad_c=n_pad_c,
                )
            R_op = FactoredRestriction(P=P_op)
        elif (isinstance(lvl_A, (DIAMatrix, StencilOperator))
              and factored_transfers) or this_bsg:
            # Factored transfers in the identity space: one selection (or a
            # brick repeat) plus a fine-level matvec.
            tval_pad = np.zeros(n_pad_f, dtype=np_dt)
            tval_pad[:n_f] = 1.0 / np.sqrt(counts[agg])
            scale_pad = np.zeros(n_pad_f, dtype=np_dt)
            scale_pad[:n_f] = (omega / lmax) / d
            scale_dev = _to_device(scale_pad, device)
            if use_brick:
                P_op = BrickProlongator(
                    tval=_to_device(tval_pad, device), scale=scale_dev,
                    A=lvl_A, dims=tuple(int(v) for v in grid_dims),
                    brick=brick, n_pad_c=n_pad_c, n_pad_f=n_pad_f,
                )
            elif bsg_tx_level and isinstance(lvl_A, BSGMatrix):
                G, GT = _build_bsg_transfers(
                    agg, counts, np.arange(n_f, dtype=np.int64), n_c,
                    n_pad_f, n_pad_c, device,
                )
                P_op = BSGTransferProlongator(
                    G=G, GT=GT, scale=scale_dev, A=lvl_A, n_pad_c=n_pad_c
                )
            else:
                agg_pad = np.zeros(n_pad_f, dtype=np.int64)
                agg_pad[:n_f] = agg
                P_op = FactoredProlongator(
                    agg=_to_device(agg_pad, device),
                    tval=_to_device(tval_pad, device),
                    scale=scale_dev, A=lvl_A, n_pad_c=n_pad_c,
                )
            R_op = FactoredRestriction(P=P_op)
            inv_diag = _inv_diag_padded(csr_k, n_pad_f, dtype, device)
        else:
            # Explicit ELL P and R (JAX amg.py:1198-1204).
            if P is None:
                P = sp.csr_matrix((Px, Pi, Pp), shape=(n_f, n_c))
            R = P.T.tocsr()
            P_op = ell_from_csr(_from_scipy(P), dtype=dtype,
                                device=device).repad(n_pad_f)
            R_op = ell_from_csr(_from_scipy(R), dtype=dtype,
                                device=device).repad(n_pad_c)
            inv_diag = _inv_diag_padded(csr_k, n_pad_f, dtype, device)
        levels.append(
            AMGLevel(
                A=lvl_A,
                P=P_op,
                R=R_op,
                inv_diag=inv_diag,
                lmax=torch.tensor(lmax, dtype=dtype),
                n_rows=n_f,
            )
        )
        A_k = A_c
        n_pads.append(n_pad_c)
        mid_bsg = coarse_bsg
        _mark("transfers")

    # Dense coarse solve, padded with identity outside the logical block.
    nc = A_k.shape[0]
    n_pad_c = n_pads[-1]
    if nc > max(4 * coarse_size, 512):
        # Aggregation stalled before reaching the target size: Jacobi
        # "coarse solve" as a 1-D inverse-diagonal vector.
        d = A_k.diagonal()
        d = np.where(d != 0, d, 1.0)
        coarse_inv_diag = np.ones(n_pad_c)
        coarse_inv_diag[:nc] = 1.0 / d
        coarse_inv = _to_device(coarse_inv_diag.astype(np_dt), device)
    else:
        dense = np.eye(n_pad_c)
        dense[:nc, :nc] = A_k.toarray()
        coarse_inv = _to_device(np.linalg.inv(dense).astype(np_dt), device)
    _mark("coarse")
    return AMGPreconditioner(
        levels=levels,
        coarse_inv=coarse_inv,
        smoother=smoother,
        smooth_steps=smooth_steps,
    )


def smoothed_aggregation_preconditioner(A_ell: ELLMatrix, **kwargs):
    """SA-AMG built straight from a device ELL operator: the host CSR is
    rebuilt from its nonzero slots (JAX's convenience, ``amg.py:1272``
    there; prefer passing the CSR).  ``kwargs`` go to
    :func:`smoothed_aggregation_setup`; ``dtype`` is the operator's and
    ``device``, unless given, its device."""
    from ...ops.csr import coo_to_csr

    cols = A_ell.cols.cpu().numpy()
    vals = A_ell.vals.cpu().numpy()
    n = A_ell.n_rows
    rows = np.repeat(np.arange(cols.shape[0]), cols.shape[1])
    mask = vals.reshape(-1) != 0
    rows, cc, vv = rows[mask], cols.reshape(-1)[mask], vals.reshape(-1)[mask]
    keep = rows < n
    csr = coo_to_csr(rows[keep], cc[keep], vv[keep].astype(np.float64),
                     (n, n))
    kwargs.setdefault("device", A_ell.device)
    return smoothed_aggregation_setup(csr, dtype=A_ell.dtype, **kwargs)
