"""The unstructured device operator: sliced ELL behind the BSG interface.

Counterpart of the JAX package's ``ops/bsg.py::BSGMatrix``.  The TPU form
(binned shuffle-gather micro-ops, ``bsg.py:1-36`` there) exists because the
TPU has no vector gather; a GPU has one, so the port keeps the operator's
job and vector-space contract and stores the matrix in a format native to
the GPU:

- **sliced ELL** with 32-row slices (one warp), each slice padded only to
  its own widest row, column-major inside a slice, int32 columns;
- values stored as JAX stores them: int8 when every value is an integer
  in [-127, 127] (the graph Laplacian), else bfloat16 when every value
  survives a round trip through it, else float32 (``storage="auto"``,
  JAX's rule, ``bsg.py:79-90, :422-434`` there); or float64 for operators
  that keep f64 coefficients;
- ``x``, ``y`` and the accumulator in the compute dtype of the vector
  passed to :meth:`BSGMatrix.matvec` (float32 or float64); a narrow value
  is converted to it before its product, as the TPU kernel converts
  (``vals.astype(float32)``, ``bsg.py:822`` there), so an exact narrow
  storage gives the float32 storage's result bit for bit.

The vector-space contract is the JAX one: vectors live in the *internal*
(RCM-permuted, padded) space of length ``n_pad`` (a multiple of 1024 for
:func:`bsg_from_csr` and :func:`bsg_from_coo`); ``put_vector`` /
``get_vector`` convert from and to original order; ``perm[i]`` is the
internal row of original row ``i``.  RCM is scipy's
``reverse_cuthill_mckee(symmetric_mode=True)``, exactly as the JAX packer
runs it, so both packages share one internal numbering.

Two layouts, as in JAX (``layout=`` of :func:`bsg_from_csr`): the dense
one above, and the ragged one, which stores the same slots and cuts every
slice into chunks of ``chunk`` slot columns (the last one shorter), with a
chunk -> slice map (JAX's ``_bsg_spmv_ragged``, ``bsg.py:857-924`` there).
:func:`sell_operator` packs rows as given (the stacked parts of
:class:`..parallel.sharded.BSGShardedOperator`) and
:func:`segment_sum_operator` a segment sum in a fixed order.

On a CUDA tensor :meth:`BSGMatrix.matvec` launches the hand-written kernel
of its layout (dense: ``csrc/spmv.cu``; ragged: ``csrc/sell_chunked_spmv.cu``,
both through :mod:`._kernels`) or raises; on a CPU tensor it evaluates
:func:`spmv_plain`, the plain PyTorch version of the same function over the
same arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ._kernels import WARP_CHUNKS
from .csr import CSRMatrix
from .reorder import rcm_order

__all__ = [
    "WARP_CHUNKS",
    "BSGMatrix",
    "bsg_from_csr",
    "bsg_from_coo",
    "bsg_spmv",
    "SEGMENT_WIDTH",
    "SegmentSum",
    "segment_sum_operator",
    "sell_operator",
    "spmv_plain",
    "sell_pack",
]

TILE = 1024  # padded-length granule of the JAX BSG layout (8 x 128 rows)
SLICE = 32  # rows per sliced-ELL slice: one warp
# Entries of a segment one thread adds before the sum is split
# (:func:`segment_sum_operator`): on the card a wider segment is a long
# chain of dependent adds, a split one a second launch.
SEGMENT_WIDTH = 64

_STORAGE = {"int8": torch.int8, "bfloat16": torch.bfloat16,
            "float32": torch.float32, "float64": torch.float64}
# Host packing type of each storage (numpy has no bfloat16: such values
# pack as float32 and narrow on the upload).
_PACK_NP = {"int8": np.int8, "bfloat16": np.float32, "float32": np.float32,
            "float64": np.float64}


@dataclasses.dataclass
class BSGMatrix:
    """Sliced-ELL sparse operator with the JAX ``BSGMatrix`` contract.

    ``slice_ptr[s]`` is the first slot of slice ``s`` (int64, length
    ``n_slices + 1``); slot ``j`` of row ``32*s + i`` is at
    ``slice_ptr[s] + 32*j + i`` in ``cols`` (int32) and ``vals``.
    The ragged layout (``chunk > 0``) keeps these slots and cuts slice ``s``
    of width ``w`` into ``ceil(w / chunk)`` chunks: chunk ``j`` of the
    slice holds its slot columns ``[chunk*j, min(chunk*(j+1), w))``.
    Chunks are numbered slice after slice; ``tmap[k]`` is the slice of
    chunk ``k`` (int32, non-decreasing) and ``chunk_ptr[s]`` the first chunk
    of slice ``s`` (int32, length ``n_slices + 1``; a slice of width 0 owns
    no chunk).  ``wide`` lists, ascending, the chunks of the slices of more
    than :data:`WARP_CHUNKS` chunks (int32), which the kernel spreads one
    chunk per warp.
    ``x_len`` is the length of the input space a matvec accepts: ``n_pad``
    for square operators, the given input length for :func:`bsg_from_coo`.
    ``shape`` is the true logical shape ``(n_rows, n_cols)``, rectangular
    for :func:`bsg_from_coo` (the JAX class reports it square).
    """

    slice_ptr: torch.Tensor  # (n_slices + 1,) int64
    cols: torch.Tensor  # (n_slots,) int32, 0 on padding slots
    vals: torch.Tensor  # (n_slots,) int8, bf16, f32 or f64; 0 on padding slots
    diag: torch.Tensor  # (n_pad,) float32 diagonal (internal order), 0-padded
    perm: Optional[torch.Tensor]  # (n_rows,) int64 original -> internal row
    n_rows: int  # logical output rows
    n_cols: int  # logical input columns
    n_pad: int  # padded output length (rows computed by a matvec)
    x_len: int  # input-space length
    chunk: int = 0  # slot columns per chunk; 0 is the dense layout
    tmap: Optional[torch.Tensor] = None  # (n_chunks,) int32 chunk -> slice
    chunk_ptr: Optional[torch.Tensor] = None  # (n_slices + 1,) int32
    wide: Optional[torch.Tensor] = None  # (n_wide,) int32 chunks, ascending
    _slot_key: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False
    )

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def storage(self) -> str:
        """``"int8"``, ``"bfloat16"``, ``"float32"`` (JAX's strings) or
        ``"float64"``."""
        return str(self.vals.dtype).replace("torch.", "")

    @property
    def dtype(self) -> torch.dtype:
        """The dtype of its vectors by default: float64 for float64
        storage, float32 for every other (the kernels also take f64
        vectors on narrower storage)."""
        if self.vals.dtype == torch.float64:
            return torch.float64
        return torch.float32

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def n_slots(self) -> int:
        return int(self.cols.numel())

    @property
    def layout(self) -> str:
        return "ragged" if self.chunk else "dense"

    @property
    def n_chunks(self) -> int:
        return int(self.tmap.numel()) if self.chunk else 0

    def put_vector(self, x, dtype=torch.float32) -> torch.Tensor:
        """Original-order (n,) host vector -> internal padded device vector."""
        x = torch.as_tensor(np.asarray(x), dtype=dtype)
        out = torch.zeros(self.n_pad, dtype=dtype)
        if self.perm is not None:
            out[self.perm.cpu()] = x
        else:
            out[: self.n_rows] = x
        return out.to(self.device)

    def get_vector(self, xp: torch.Tensor) -> np.ndarray:
        """Internal padded device vector -> original-order (n,) host vector."""
        if self.perm is not None:
            return xp[self.perm].cpu().numpy()
        return xp[: self.n_rows].cpu().numpy()

    def diagonal_padded(self, fill: float = 1.0) -> torch.Tensor:
        return self.diag.masked_fill(self.diag == 0, fill)

    def matvec(self, x_padded: torch.Tensor) -> torch.Tensor:
        return bsg_spmv(self, x_padded)

    def matvec_reference(self, x_padded: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch evaluation on any device (validation only)."""
        return spmv_plain(self, x_padded)

    def slot_key(self) -> torch.Tensor:
        """Where every slot's product is added in :func:`spmv_plain`
        (int64, built once): its row in the dense layout, its chunk's
        partial ``32 * chunk + lane`` in the ragged one."""
        if self._slot_key is None:
            widths = (self.slice_ptr[1:] - self.slice_ptr[:-1]) // SLICE
            n_slices = widths.numel()
            slice_of = torch.repeat_interleave(
                torch.arange(n_slices, device=self.device), widths * SLICE
            )
            within = torch.arange(self.n_slots, device=self.device) - (
                self.slice_ptr[:-1][slice_of]
            )
            first = slice_of
            if self.chunk:
                first = (self.chunk_ptr.to(torch.int64)[slice_of]
                         + within // (SLICE * self.chunk))
            self._slot_key = first * SLICE + within % SLICE
        return self._slot_key


def _check_input(A: BSGMatrix, x: torch.Tensor) -> None:
    if x.dim() != 1:
        raise ValueError(f"matvec takes a 1-D vector, got shape {tuple(x.shape)}")
    if x.numel() > A.x_len:
        raise ValueError(
            f"input of length {x.numel()} exceeds the operator's input "
            f"space ({A.x_len})"
        )
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported vector dtype {x.dtype}")
    if A.vals.dtype == torch.float64 and x.dtype != torch.float64:
        raise TypeError("float64-stored operator needs float64 vectors")
    if x.device != A.device:
        raise ValueError(f"x is on {x.device}, the operator on {A.device}")


def spmv_plain(A: BSGMatrix, x_padded: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch sliced-ELL SpMV: a gather, a multiply and a row sum
    over the kernel's own arrays, in the kernel's slot order per row.

    The ragged layout is summed as its kernel sums it: one partial per row
    of every chunk (its columns in order), then the partials of a slice's
    chunks added in chunk order.  Same contract as the kernels: columns
    past ``len(x)`` read 0 (a shorter input is zero-extended), empty and
    padding rows give 0."""
    _check_input(A, x_padded)
    n_x = x_padded.numel()
    xe = torch.cat([x_padded, x_padded.new_zeros(1)])
    idx = A.cols.to(torch.int64).clamp_(max=n_x)
    prod = A.vals.to(x_padded.dtype) * xe[idx]
    # The last slice may run past n_pad (a multiple of 8); its extra rows
    # hold padding slots only.
    n_slices = A.slice_ptr.numel() - 1
    if A.chunk:
        partial = x_padded.new_zeros(A.n_chunks * SLICE)
        partial.index_add_(0, A.slot_key(), prod)
        y = x_padded.new_zeros((n_slices, SLICE))
        y.index_add_(0, A.tmap.to(torch.int64), partial.view(-1, SLICE))
        return y.view(-1)[: A.n_pad]
    y = x_padded.new_zeros(n_slices * SLICE)
    return y.index_add_(0, A.slot_key(), prod)[: A.n_pad]


def bsg_spmv(A: BSGMatrix, x_padded: torch.Tensor) -> torch.Tensor:
    """y = A @ x in the internal padded space.

    A CUDA tensor goes to the hand-written kernel of the operator's layout
    (which raises on failure); a CPU tensor to :func:`spmv_plain`.  Nothing
    moves between devices."""
    if x_padded.device.type == "cpu":
        return spmv_plain(A, x_padded)
    _check_input(A, x_padded)
    if x_padded.device.type != "cuda":
        raise ValueError(f"no SpMV for device {x_padded.device}")
    from ._kernels import sell_chunked_spmv, sell_spmv

    if A.chunk:
        return sell_chunked_spmv(A.slice_ptr, A.cols, A.vals, A.tmap,
                                 A.chunk_ptr, A.wide, A.chunk,
                                 x_padded.contiguous(), A.n_pad)
    return sell_spmv(A.slice_ptr, A.cols, A.vals, x_padded.contiguous(),
                     A.n_pad)


# ---------------------------------------------------------------------------
# Host packing
# ---------------------------------------------------------------------------


def _slice_widths(indptr: np.ndarray, n_pad: int) -> np.ndarray:
    """Widest row of every 32-row slice of ``n_pad`` rows."""
    n = indptr.size - 1
    lens = np.zeros(-(-n_pad // SLICE) * SLICE, dtype=np.int64)
    lens[:n] = np.diff(indptr)
    return lens.reshape(-1, SLICE).max(axis=1)


def sell_pack(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
              n_pad: int, value_dtype=np.float32, pad_col: int = 0):
    """Pack row-sorted CSR arrays (``len(indptr) - 1 <= n_pad`` rows) into
    sliced-ELL host arrays ``(slice_ptr, cols, vals)``, each slice as wide
    as its widest row, each row's slots in the order given (both layouts).
    Padding slots hold value 0 and column ``pad_col``."""
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.size - 1
    widths = _slice_widths(indptr, n_pad)
    n_slices = widths.size
    lens = np.diff(indptr)
    slice_ptr = np.zeros(n_slices + 1, dtype=np.int64)
    np.cumsum(widths * SLICE, out=slice_ptr[1:])
    n_slots = int(slice_ptr[-1])
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    pos = np.arange(nnz, dtype=np.int64) - indptr[rows]
    dst = slice_ptr[rows // SLICE] + pos * SLICE + rows % SLICE
    cols = np.full(n_slots, pad_col, dtype=np.int32)
    vals = np.zeros(n_slots, dtype=value_dtype)
    cols[dst] = indices
    vals[dst] = data
    return slice_ptr, cols, vals


def _rcm_perm(csr: CSRMatrix) -> np.ndarray:
    """``perm[i]`` = internal row of original row ``i`` — the JAX packer's
    RCM (scipy's, ``bsg.py:220-234`` there), so both packages number
    alike."""
    order = rcm_order(csr, native=False)
    perm = np.empty(csr.n_rows, dtype=np.int64)
    perm[order] = np.arange(csr.n_rows)
    return perm


def _int8_exact(vals: np.ndarray) -> bool:
    """True iff every value is an integer in [-127, 127] (JAX's gate,
    ``bsg.py:79`` there): the graph Laplacian's degrees and -1s qualify,
    so its values store as int8, 1 byte a slot instead of 4."""
    if not vals.size:
        return True
    m = float(np.abs(vals).max())
    return m <= 127 and bool(np.all(vals == np.rint(vals)))


def _resolve_storage(storage: str, data: np.ndarray) -> str:
    """The storage string for ``data``: ``"auto"`` takes JAX's rule -- int8
    when :func:`_int8_exact`, else bfloat16 when every value survives
    bfloat16, else float32; a named storage is kept (values are cast to
    it, as JAX casts them)."""
    if storage == "auto":
        from .dia import _bf16_exact

        data = np.asarray(data)
        if _int8_exact(data):
            return "int8"
        if _bf16_exact(data):
            return "bfloat16"
        return "float32"
    if storage not in _STORAGE:
        raise ValueError("storage must be auto|int8|bfloat16|float32|float64, "
                         f"got {storage!r}")
    return storage


def _chunk_maps(slice_ptr: np.ndarray, chunk: int):
    """``(tmap, chunk_ptr, wide)`` of a ragged pack: a slice of width ``w``
    owns ``ceil(w / chunk)`` chunks, numbered slice after slice; ``wide``
    lists the chunks of slices of more than :data:`WARP_CHUNKS` chunks."""
    widths = np.diff(slice_ptr) // SLICE
    per_slice = -(-widths // chunk)
    tmap = np.repeat(np.arange(per_slice.size, dtype=np.int32), per_slice)
    chunk_ptr = np.zeros(per_slice.size + 1, dtype=np.int32)
    np.cumsum(per_slice, out=chunk_ptr[1:])
    wide = np.flatnonzero(per_slice[tmap] > WARP_CHUNKS).astype(np.int32)
    return tmap, chunk_ptr, wide


def _upload(slice_ptr, cols, vals, storage, diag, perm, n_rows, n_cols, n_pad,
            x_len, device, chunk: int = 0) -> BSGMatrix:
    dev = resolve_device(device)
    maps = {}
    if chunk:
        tmap, chunk_ptr, wide = _chunk_maps(slice_ptr, chunk)
        maps = dict(chunk=int(chunk), tmap=torch.from_numpy(tmap).to(dev),
                    chunk_ptr=torch.from_numpy(chunk_ptr).to(dev),
                    wide=torch.from_numpy(wide).to(dev))
    return BSGMatrix(
        slice_ptr=torch.from_numpy(slice_ptr).to(dev),
        cols=torch.from_numpy(cols).to(dev),
        vals=torch.from_numpy(vals).to(_STORAGE[storage]).to(dev),
        diag=torch.from_numpy(diag).to(dev),
        perm=torch.from_numpy(perm).to(dev) if perm is not None else None,
        n_rows=int(n_rows),
        n_cols=int(n_cols),
        n_pad=int(n_pad),
        x_len=int(x_len),
        **maps,
    )


def bsg_from_csr(
    csr: CSRMatrix,
    *,
    reorder: bool = True,
    perm: Optional[np.ndarray] = None,
    storage: str = "auto",
    row_multiple: int = TILE,
    layout: str = "auto",
    chunk: int = 16,
    device=None,
) -> BSGMatrix:
    """Pack a square CSR matrix as a sliced-ELL operator.

    ``reorder=True`` applies the RCM symmetric permutation first (tighter
    column clusters per slice: fewer x cache lines per warp); ``perm``
    adopts a given permutation instead (e.g. a JAX operator's ``perm``).
    ``storage="auto"`` takes JAX's rule (:func:`_resolve_storage`: int8
    for the graph Laplacian, else bfloat16 when exact, else float32);
    ``"int8"``, ``"bfloat16"`` and ``"float32"`` force JAX's storages,
    ``"float64"`` keeps f64 coefficients (the port's only).
    The padded length is a multiple of ``row_multiple``: 1024 by default,
    as in the JAX BSG layout; AMG levels outside the BSG chain pad to 8, as
    the JAX package pads its ELL levels.  ``device`` defaults to the card.

    ``layout="ragged"`` keeps the dense layout's slots and cuts every
    slice into chunks of ``chunk`` slot columns (default 16, as in JAX; a
    slice's last chunk holds what remains), with a chunk -> slice map.  Its
    CUDA product gives a slice of at most :data:`WARP_CHUNKS` chunks one
    warp, which adds the chunks' partials in chunk order, and spreads a
    wider slice one chunk per warp, so a wide slice (the transposed
    tentative transfer of AMG) does not hold one warp for its whole width.
    JAX caps the number of chunks (``_TMAP_CAP``, widening ``chunk``)
    because its map must fit the TPU's 1 MB scalar memory; the GPU reads
    the map from device memory, so the port has no cap.  ``layout="auto"``
    is the dense layout.  JAX's rule (``bsg.py:359-385`` there) picks
    ragged only when the dense slot arrays exceed 4 GB and the chunked form
    stores at most 0.9x their bytes: its dense layout pads every tile to
    the widest tile, so its chunked form can be smaller.  The port's two
    layouts store the same slots, so that rule always keeps the dense
    layout.  JAX measured ragged as "a memory-footprint lever, not a speed
    lever" (``bsg.py:275-283`` there)."""
    if csr.shape[0] != csr.shape[1]:
        raise ValueError("bsg_from_csr requires a square operator")
    if layout not in ("auto", "dense", "ragged"):
        raise ValueError(f"layout must be auto|dense|ragged, got {layout!r}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    import scipy.sparse as sp

    n = csr.n_rows
    if perm is None and reorder:
        perm = _rcm_perm(csr)
    S = sp.csr_matrix(
        (np.asarray(csr.data), np.asarray(csr.indices), np.asarray(csr.indptr)),
        shape=csr.shape,
    )
    if perm is not None:
        perm = np.array(perm, dtype=np.int64)  # writable, for torch
        order = np.empty(n, dtype=np.int64)
        order[perm] = np.arange(n, dtype=np.int64)
        S = S[order][:, order]
    S = S.tocsr()
    S.sort_indices()
    n_pad = max(1, -(-n // row_multiple)) * row_multiple
    storage = _resolve_storage(storage, S.data)
    chunk = chunk if layout == "ragged" else 0
    slice_ptr, cols, vals = sell_pack(
        S.indptr, S.indices, S.data, n_pad, value_dtype=_PACK_NP[storage],
    )
    diag = np.zeros(n_pad, dtype=np.float32)
    diag[:n] = S.diagonal().astype(np.float32)
    return _upload(slice_ptr, cols, vals, storage, diag, perm, n, n, n_pad,
                   n_pad, device, chunk=chunk)


def bsg_from_coo(
    rows,
    cols,
    data,
    n_rows: int,
    x_len: int,
    *,
    storage: str = "auto",
    device=None,
) -> BSGMatrix:
    """Pack an arbitrary (possibly rectangular) COO pattern.

    ``rows`` index the output space ``[0, n_rows)`` and ``cols`` the input
    space ``[0, x_len)``; both numberings are taken as given.  Duplicate
    entries are kept as separate slots (their products are summed).  The
    output space is padded to a multiple of 1024 rows; ``matvec`` takes
    inputs of length <= ``x_len`` (shorter ones are zero-extended)."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    data = np.ascontiguousarray(data, np.float64)
    if cols.size and (cols.min() < 0 or cols.max() >= x_len):
        raise ValueError("column index outside [0, x_len)")
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows):
        raise ValueError("row index outside [0, n_rows)")
    o = np.lexsort((cols, rows))
    rows, cols, data = rows[o], cols[o], data[o]
    n_pad = max(1, -(-int(n_rows) // TILE)) * TILE
    indptr = np.zeros(int(n_rows) + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=int(n_rows)), out=indptr[1:])
    storage = _resolve_storage(storage, data)
    slice_ptr, cols_s, vals_s = sell_pack(
        indptr, cols, data, n_pad, value_dtype=_PACK_NP[storage],
    )
    diag = np.zeros(n_pad, dtype=np.float32)
    return _upload(slice_ptr, cols_s, vals_s, storage, diag, None, n_rows,
                   x_len, n_pad, x_len, device)


def sell_operator(indptr, indices, data, x_len: int, *, storage: str,
                  device=None) -> BSGMatrix:
    """Pack CSR arrays as a sliced-ELL operator with each row's slots in
    the order given and no padded rows: ``n_pad`` is the row count, which
    need not be a multiple of 32 (the last slice's extra lanes are
    masked), and padding slots point past the input (``x_len``).  For
    operators whose slot order is fixed by their caller: the stacked parts
    of a partitioned operator, a segment sum."""
    indptr = np.asarray(indptr, dtype=np.int64)
    n_rows = indptr.size - 1
    data = np.asarray(data)
    storage = _resolve_storage(storage, data)
    slice_ptr, cols, vals = sell_pack(
        indptr, np.asarray(indices), data, n_rows,
        value_dtype=_PACK_NP[storage], pad_col=int(x_len),
    )
    diag = np.zeros(n_rows, dtype=np.float32)
    return _upload(slice_ptr, cols, vals, storage, diag, None, n_rows,
                   x_len, n_rows, x_len, device)


@dataclasses.dataclass
class SegmentSum:
    """``y[j] = sum of x[i] over i with seg[i] == j`` in a fixed order, on
    kernel 1 (:func:`segment_sum_operator`): ``pieces`` adds each run of
    at most ``width`` consecutive entries of a segment (ascending ``i``),
    ``total`` adds a segment's pieces in order.  ``total`` is None when
    every segment is one piece: then ``pieces`` is the whole sum, one row
    per segment."""

    pieces: BSGMatrix  # (n_pieces rows) over x, int8 ones
    total: Optional[BSGMatrix]  # (n_seg rows) over the pieces, int8 ones
    width: int

    @property
    def operators(self) -> Tuple[BSGMatrix, ...]:
        return (self.pieces,) if self.total is None else (self.pieces,
                                                          self.total)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pieces.matvec(x)
        return y if self.total is None else self.total.matvec(y)


def _ones(indptr, cols, x_len, device) -> BSGMatrix:
    return sell_operator(indptr, cols, np.ones(cols.size, np.int8), x_len,
                         storage="int8", device=device)


def segment_sum_operator(seg: np.ndarray, n_seg: int, valid=None, *,
                         width: int = SEGMENT_WIDTH,
                         device=None) -> SegmentSum:
    """``y[j] = sum of x[i] over i with seg[i] == j`` (over the ``i`` where
    ``valid`` is true, all by default), each segment added in ascending
    ``i`` in pieces of at most ``width`` entries, then the pieces in order
    (:class:`SegmentSum`): int8 ones on kernel 1.  A scatter-add on the
    card adds with atomics, in an order that changes from run to run; this
    sum does not (each row is one thread's, its slots in order).  One
    thread per segment would add a wide aggregate (hundreds of fine rows)
    in one long chain, so a segment wider than ``width`` is split over
    several threads.  Where no segment is, the sum is one launch and its
    plain version on a CPU tensor adds in ``index_add_``'s order, bit for
    bit (the products with 1 are exact)."""
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    seg = np.asarray(seg, dtype=np.int64)
    i = (np.arange(seg.size, dtype=np.int64) if valid is None
         else np.flatnonzero(np.asarray(valid)))
    order = np.argsort(seg[i], kind="stable")
    rows, cols = seg[i][order], i[order]
    lens = np.bincount(rows, minlength=int(n_seg))
    n_pieces = -(-lens // width)  # pieces per segment
    if not (lens > width).any():
        indptr = np.zeros(int(n_seg) + 1, dtype=np.int64)
        np.cumsum(lens, out=indptr[1:])
        return SegmentSum(_ones(indptr, cols, seg.size, device), None, width)
    # Piece q of segment j holds its entries [width*q, width*(q+1)).
    first = np.zeros(int(n_seg) + 1, dtype=np.int64)  # first piece of j
    np.cumsum(n_pieces, out=first[1:])
    start = np.zeros(int(n_seg), dtype=np.int64)  # first entry of j
    np.cumsum(lens[:-1], out=start[1:])
    pos = np.arange(cols.size, dtype=np.int64) - start[rows]
    piece_of = first[rows] + pos // width
    p_indptr = np.zeros(int(first[-1]) + 1, dtype=np.int64)
    np.cumsum(np.bincount(piece_of, minlength=int(first[-1])),
              out=p_indptr[1:])
    pieces = _ones(p_indptr, cols, seg.size, device)
    total = _ones(first, np.arange(first[-1], dtype=np.int64),
                  int(first[-1]), device)
    return SegmentSum(pieces, total, width)
