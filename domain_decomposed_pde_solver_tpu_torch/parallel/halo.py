"""Static halo-exchange plans for domain-decomposed SpMV.

This module replaces the *entire* runtime communication protocol of the
reference — MPI one-sided windows fetching remapped indices
(``ExodusIO.hpp:429-576``), the ghost-node frequency-ownership exchange
(``:1121-1384``), and Tpetra's Import/Export halo machinery — with **one
host-side precomputation**: every index a part will ever need is computed
here, once, at partition time, so the runtime exchange is one gather on
fixed-shape buffers.  A numpy copy of the JAX package's
``parallel/halo.py``; its arrays are JAX's, bit for bit.

Layout produced for P parts from a CSR matrix + a part assignment:

- rows are permuted owner-contiguous and each part padded to the same local
  size ``n_local`` (multiple of 8);
- each part's matrix block is ELL with columns remapped into its *extended*
  local vector ``[x_own (n_local) | halo (P*H)]``: own columns point into
  ``[0, n_local)``, a column owned by part q at q-local index j that part p
  receives in halo slot s points at ``n_local + q*H + s``;
- ``send_idx[p, q, :]`` lists the q-destined local indices of part p's own
  values, padded to the uniform width H by repeating index 0 (harmless:
  receivers only read the slots their columns reference).

The exchange for part p is then ``sendbuf[q] = x_own[send_idx[p, q]]`` on
every part and an all-to-all of those buffers, after which ``halo[q, s]``
is exactly ``x_q[send_idx[q, p, s]]`` (:func:`.sharded.halo_exchange`
does it as one gather over the ``(P, n_local)`` vector).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.csr import CSRMatrix
from ..ops.ell import pad_to

__all__ = ["HaloPlan", "build_halo_plan"]


@dataclasses.dataclass
class HaloPlan:
    """Host-side description of a P-way row partition with halo exchange."""

    nparts: int
    n_global: int  # logical (unpadded) global row count
    n_local: int  # padded per-part row count
    halo_width: int  # H: max entries exchanged between any ordered pair
    # Permutations between global (original) and partitioned numbering:
    perm: np.ndarray  # (n_global,) partitioned position -> original row
    part_of_row: np.ndarray  # (n_global,) original row -> part
    local_of_row: np.ndarray  # (n_global,) original row -> local slot in part
    # Per-part packed arrays (leading axis = part):
    ell_cols: np.ndarray  # (P, n_local, K) int32, extended-local columns
    ell_vals: np.ndarray  # (P, n_local, K) float64
    send_idx: np.ndarray  # (P, P, H) int32 into the part's own x
    row_valid: np.ndarray  # (P, n_local) bool — real row vs padding

    @property
    def ell_width(self) -> int:
        return int(self.ell_cols.shape[2])

    # -- vector redistribution helpers (host side) ---------------------
    def scatter_vector(self, x_global: np.ndarray, dtype=None) -> np.ndarray:
        """(n_global,) -> (P, n_local) padded, part-ordered."""
        out = np.zeros(
            (self.nparts, self.n_local),
            dtype=x_global.dtype if dtype is None else np.dtype(dtype),
        )
        out[self.part_of_row, self.local_of_row] = x_global
        return out

    def gather_vector(self, x_parts: np.ndarray) -> np.ndarray:
        """(P, n_local) -> (n_global,) in original row order."""
        return np.asarray(x_parts)[self.part_of_row, self.local_of_row]


def build_halo_plan(
    A: CSRMatrix,
    parts: np.ndarray,
    nparts: int,
    row_multiple: int = 8,
    width_multiple: int = 1,
    dtype=np.float64,
) -> HaloPlan:
    """Build the static plan for ``y = A x`` with rows/x sharded by ``parts``.

    ``A`` must be square with matching row/column numbering (the reduced
    Laplacian).  Complexity O(nnz log nnz), runs once per mesh/partition.
    """
    n = A.n_rows
    assert A.n_cols == n, "halo plan requires a square operator"
    parts = np.asarray(parts, dtype=np.int32)

    # Owner-contiguous permutation; local index within each part.
    perm = np.argsort(parts, kind="stable").astype(np.int64)
    sizes = np.bincount(parts, minlength=nparts)
    part_of_row = parts
    local_of_row = np.zeros(n, dtype=np.int64)
    local_of_row[perm] = np.arange(n) - np.repeat(
        np.concatenate([[0], np.cumsum(sizes)[:-1]]), sizes
    )
    n_local = pad_to(int(sizes.max()) if n else 1, row_multiple)

    # Halo discovery: for ordered pair (owner q -> user p), the set of
    # q-owned columns referenced by p's rows.
    rows = np.repeat(np.arange(n), A.row_lengths())
    p_of_r = parts[rows]
    p_of_c = parts[A.indices]
    off = p_of_r != p_of_c
    # Unique (user p, owner q, column) triples.
    tri = np.stack(
        [p_of_r[off].astype(np.int64), p_of_c[off].astype(np.int64), A.indices[off]],
        axis=1,
    )
    tri = np.unique(tri, axis=0) if tri.size else tri.reshape(0, 3)
    pair_counts = np.zeros((nparts, nparts), dtype=np.int64)
    if tri.size:
        np.add.at(pair_counts, (tri[:, 0], tri[:, 1]), 1)
    H = max(int(pair_counts.max()), 1)

    # send_idx[q, p, s] = q-local index of the s-th value q sends to p.
    send_idx = np.zeros((nparts, nparts, H), dtype=np.int32)
    # halo_slot of each (p, q, col): position s in the (q -> p) message.
    halo_slot = np.zeros(tri.shape[0], dtype=np.int64)
    if tri.size:
        # tri is sorted lexicographically by (p, q, col); slot = rank within group.
        group_key = tri[:, 0] * nparts + tri[:, 1]
        _, starts = np.unique(group_key, return_index=True)
        group_start = np.zeros(tri.shape[0], dtype=np.int64)
        group_start[starts] = starts
        np.maximum.accumulate(group_start, out=group_start)
        halo_slot = np.arange(tri.shape[0]) - group_start
        send_idx[tri[:, 1], tri[:, 0], halo_slot] = local_of_row[tri[:, 2]].astype(
            np.int32
        )

    # Extended-local column remapping.
    # Own columns: local index. Halo columns: n_local + q*H + slot.
    # Build a lookup from (p, original col) -> extended index via a dict-free
    # two-level scheme: same-part columns direct; off-part through tri order.
    ext_col = np.zeros(A.nnz, dtype=np.int64)
    same = ~off
    ext_col[same] = local_of_row[A.indices[same]]
    if tri.size:
        # Map each off-part (p, col) occurrence to its slot via searchsorted
        # on the unique triple key.
        tri_key = (tri[:, 0] * nparts + tri[:, 1]) * np.int64(n) + tri[:, 2]
        occ_key = (
            p_of_r[off].astype(np.int64) * nparts + p_of_c[off].astype(np.int64)
        ) * np.int64(n) + A.indices[off]
        pos = np.searchsorted(tri_key, occ_key)
        ext_col[off] = n_local + tri[pos, 1] * H + halo_slot[pos]

    # Pack per-part ELL.
    lens = A.row_lengths()
    K = max(pad_to(int(lens.max()) if n else 1, width_multiple), 1)
    ell_cols = np.zeros((nparts, n_local, K), dtype=np.int32)
    ell_vals = np.zeros((nparts, n_local, K), dtype=np.dtype(dtype))
    slot_in_row = np.arange(A.nnz) - np.repeat(A.indptr[:-1], lens)
    ell_cols[p_of_r, local_of_row[rows], slot_in_row] = ext_col.astype(np.int32)
    ell_vals[p_of_r, local_of_row[rows], slot_in_row] = A.data.astype(
        np.dtype(dtype)
    )

    row_valid = np.zeros((nparts, n_local), dtype=bool)
    row_valid[part_of_row, local_of_row] = True

    return HaloPlan(
        nparts=nparts,
        n_global=n,
        n_local=n_local,
        halo_width=H,
        perm=perm,
        part_of_row=part_of_row,
        local_of_row=local_of_row,
        ell_cols=ell_cols,
        ell_vals=ell_vals,
        send_idx=send_idx,
        row_valid=row_valid,
    )
