"""Distributed assembly: per-rank element slices to per-rank matrix rows.

A numpy copy of the JAX package's ``parallel/distassembly.py`` with the
port's own imports; its plan arrays are JAX's, bit for bit.  The
multi-process flavour exchanges over ``torch.distributed``
(:mod:`.collectives`) where JAX uses a device ``all_to_all``.

This composes the ingredients the framework already had — mmap element
slices (:func:`..io.exodus.read_exodus_partial`), O(N) node metadata
(:func:`..io.exodus.read_exodus_node_data`), deterministic coordinate RCB
(:func:`.partition.partition_rcb`) and the halo-plan layout
(:mod:`.halo`) — into the reference's *element path*: every rank reads
only its contiguous slice of the connectivity, redistributes
contributions to row owners, and assembles ONLY ITS ROWS of the reduced
Laplacian.  **No host ever materializes the global CSR.**

Reference counterpart: ``ExodusIO.hpp:733-1489`` — per-rank block element
read (``:781-828``), ParMETIS + element redistribution (``:989-1069``),
the ghost-node ownership protocol (``:1121-1384``), and per-rank row fill
(``:1390-1489``).  The reference needs four MPI protocols because no rank
knows the partition globally; here the row partition is a *deterministic
pure function of the node coordinates* (RCB), which every rank computes
identically from the O(N) node block it already reads (the reference
accepts the same O(N)-per-rank node metadata cost, ``ExodusIO.hpp:155``),
so:

- ``local_of_row`` / ``n_local`` / part sizes need NO communication;
- each rank's ``send_idx`` (what it must ship during the runtime halo
  exchange) is computable from its OWN rows alone, because the reduced
  Laplacian is structurally symmetric: rank p must send row-value c to q
  iff column c appears in q's rows iff row c (p's own) references a
  column owned by q;
- the ONLY bulk communication is one all-to-all of unique edge keys
  ``row*num_nodes + col`` to row owners (elements straddling a slice
  boundary contribute the same edge on two ranks; owners dedup with one
  ``np.unique``), plus two scalar max-reductions for the uniform halo
  width H and ELL width K.

The packed per-rank blocks are bit-identical to the corresponding slices
of :func:`..parallel.halo.build_halo_plan` run on the globally assembled
matrix with the same partition (asserted in ``tests/test_distassembly.py``
and the 2-process harness; the port's against JAX's in
``tests/test_torch_distassembly.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..io.exodus import read_exodus_node_data, read_exodus_partial
from ..io.mesh import boundary_value_from_sets
from ..models.heat import edges_from_blocks
from ..ops.ell import pad_to
from .collectives import (
    comm_device,
    exchange_rows,
    gather_parts,
    max_scalar,
    process_rank,
    process_world,
)
from .halo import HaloPlan
from .partition import partition_rcb

__all__ = [
    "DistLocalState",
    "DistRankRows",
    "DistRankBlock",
    "dist_local_phase",
    "dist_rank_rows",
    "dist_pack_block",
    "assemble_heat_distributed",
    "multihost_exchange_keys",
    "multihost_max_scalar",
    "assemble_heat_multihost",
]


def _rank_of_part(parts: np.ndarray, nparts: int, nranks: int) -> np.ndarray:
    if nparts % nranks:
        raise ValueError(f"nparts={nparts} not divisible by nranks={nranks}")
    return parts // (nparts // nranks)


@dataclasses.dataclass
class DistLocalState:
    """Phase-1 output: everything rank-deterministic plus outgoing keys.

    All O(N) fields (ownership, numbering, boundary data) are identical on
    every rank by construction — computed from the shared node block, never
    exchanged.
    """

    rank: int
    nranks: int
    nparts: int
    num_nodes: int
    n_free: int
    free_to_node: np.ndarray  # (n_free,) global node id per free row
    node_to_free: np.ndarray  # (num_nodes,) or -1
    is_boundary: np.ndarray
    bval: np.ndarray
    owner_free: np.ndarray  # (n_free,) part id per free row (deterministic RCB)
    part_sizes: np.ndarray  # (nparts,)
    n_local: int  # padded rows per part
    local_of_row: np.ndarray  # (n_free,) local slot within owning part
    send_keys: List[np.ndarray]  # per-destination-RANK unique int64 keys


def dist_local_phase(
    path: str,
    rank: int,
    nranks: int,
    nparts: Optional[int] = None,
    row_multiple: int = 8,
) -> DistLocalState:
    """Read this rank's element slice and bucket edge keys by owner rank.

    ``nparts`` (row partitions) may exceed ``nranks`` (processes); parts
    map to ranks contiguously as in :meth:`.sharded.DeviceMesh.local`.
    """
    nparts = nranks if nparts is None else nparts
    num_nodes, coords, node_sets = read_exodus_node_data(path)
    is_boundary, bval = boundary_value_from_sets(num_nodes, node_sets)
    free_to_node = np.nonzero(~is_boundary)[0].astype(np.int64)
    node_to_free = np.full(num_nodes, -1, dtype=np.int64)
    node_to_free[free_to_node] = np.arange(free_to_node.size)
    n_free = int(free_to_node.size)

    # Deterministic row partition: pure function of the free-node coords.
    owner_free = (
        partition_rcb(coords[free_to_node], nparts).astype(np.int32)
        if n_free
        else np.zeros(0, np.int32)
    )
    part_sizes = np.bincount(owner_free, minlength=nparts)
    n_local = pad_to(int(part_sizes.max()) if n_free else 1, row_multiple)
    # local slot = rank of the row within its part, in global row order —
    # identical to build_halo_plan's stable-argsort derivation.
    perm = np.argsort(owner_free, kind="stable").astype(np.int64)
    local_of_row = np.zeros(n_free, dtype=np.int64)
    if n_free:
        starts = np.concatenate([[0], np.cumsum(part_sizes)[:-1]])
        local_of_row[perm] = np.arange(n_free) - np.repeat(starts, part_sizes)

    # This rank's element slice -> unique local (u, v) node pairs.
    sl = read_exodus_partial(path, rank, nranks)
    u, v = edges_from_blocks(sl.blocks, num_nodes)
    src_free = ~is_boundary[u] if u.size else np.zeros(0, bool)
    u, v = u[src_free], v[src_free]
    ru = node_to_free[u]
    keys = ru * np.int64(num_nodes) + v  # already unique + sorted per slice
    dest = _rank_of_part(owner_free[ru], nparts, nranks)
    order = np.argsort(dest, kind="stable")
    keys, dest = keys[order], dest[order]
    counts = np.bincount(dest, minlength=nranks)
    offs = np.concatenate([[0], np.cumsum(counts)])
    send_keys = [
        np.ascontiguousarray(keys[offs[r] : offs[r + 1]]) for r in range(nranks)
    ]

    return DistLocalState(
        rank=rank,
        nranks=nranks,
        nparts=nparts,
        num_nodes=num_nodes,
        n_free=n_free,
        free_to_node=free_to_node,
        node_to_free=node_to_free,
        is_boundary=is_boundary,
        bval=bval,
        owner_free=owner_free,
        part_sizes=part_sizes,
        n_local=n_local,
        local_of_row=local_of_row,
        send_keys=send_keys,
    )


@dataclasses.dataclass
class DistRankRows:
    """This rank's assembled rows (CSR over global free indices) + the
    pre-reduction widths that must be max-reduced before packing."""

    my_rows: np.ndarray  # (n_my,) global free row ids owned by my parts
    indptr: np.ndarray  # (n_my + 1,)
    indices: np.ndarray  # global free column ids (diag included, sorted)
    data: np.ndarray
    b_local: np.ndarray  # (n_my,) RHS for my rows
    local_K: int  # max row length on this rank
    local_H: int  # max |{cols needed from one part}| over my (p, q) pairs


def dist_rank_rows(
    state: DistLocalState, recv_keys: Sequence[np.ndarray], dtype=np.float64
) -> DistRankRows:
    """Merge received edge keys and assemble this rank's rows.

    Row semantics exactly match :func:`..models.heat.assemble_heat_system`
    (diag = count of ALL distinct neighbors, off-diag -1 per free
    neighbor, b = sum of boundary-neighbor nodeset ids).
    """
    nn = np.int64(state.num_nodes)
    parts_lo = state.rank * (state.nparts // state.nranks)
    parts_hi = parts_lo + (state.nparts // state.nranks)
    mine = (state.owner_free >= parts_lo) & (state.owner_free < parts_hi)
    my_rows = np.nonzero(mine)[0].astype(np.int64)
    row_rank = np.full(state.n_free, -1, dtype=np.int64)
    row_rank[my_rows] = np.arange(my_rows.size)

    allk = [k for k in recv_keys if k.size]
    keys = (
        np.unique(np.concatenate(allk)) if allk else np.zeros(0, np.int64)
    )
    ru = keys // nn
    vv = keys % nn
    r = row_rank[ru]
    assert (r >= 0).all(), "received a key for a row this rank does not own"

    # Degree (all neighbors) and RHS (boundary neighbors).
    degree = np.bincount(r, minlength=my_rows.size).astype(dtype)
    bmask = state.is_boundary[vv]
    b_local = np.zeros(my_rows.size, dtype=dtype)
    np.add.at(b_local, r[bmask], state.bval[vv[bmask]].astype(dtype))

    # Off-diagonals: free neighbors only; keys are sorted by (row, node id)
    # and node_to_free is monotone, so columns ascend within each row.
    fr = r[~bmask]
    fc = state.node_to_free[vv[~bmask]]
    nnz_off = fr.size
    counts_off = np.bincount(fr, minlength=my_rows.size)
    indptr_off = np.concatenate([[0], np.cumsum(counts_off)])
    nnz = nnz_off + my_rows.size
    indices = np.empty(nnz, dtype=np.int64)
    data = np.empty(nnz, dtype=dtype)
    # Same sort-free diagonal insertion as assemble_heat_system: entry k
    # shifts by the number of prior diagonal insertions.
    diag_col = my_rows  # the row's own global free index
    pos_off = np.arange(nnz_off, dtype=np.int64) + fr + (fc > diag_col[fr])
    indices[pos_off] = fc
    data[pos_off] = -1.0
    n_before = np.bincount(fr[fc < diag_col[fr]], minlength=my_rows.size)
    pos_diag = indptr_off[:-1] + np.arange(my_rows.size, dtype=np.int64) + n_before
    indices[pos_diag] = diag_col
    data[pos_diag] = degree
    indptr = indptr_off + np.arange(my_rows.size + 1, dtype=np.int64)

    local_K = int((indptr[1:] - indptr[:-1]).max()) if my_rows.size else 1

    # Max off-part column-set size over my (user part, owner part) pairs:
    # the local contribution to the uniform halo width H.  (indices are
    # unique per row already, so unique (p, q, col) triples suffice.)
    rp = state.owner_free[ru[~bmask]]
    cp = state.owner_free[fc]
    off = rp != cp
    local_H = 1
    if off.any():
        tri = np.unique(
            (rp[off].astype(np.int64) * state.nparts + cp[off])
            * np.int64(state.n_free)
            + fc[off]
        )
        pair = tri // np.int64(state.n_free)
        local_H = int(np.bincount(pair - pair.min()).max())

    return DistRankRows(
        my_rows=my_rows,
        indptr=indptr,
        indices=indices,
        data=data,
        b_local=b_local,
        local_K=local_K,
        local_H=local_H,
    )


@dataclasses.dataclass
class DistRankBlock:
    """Packed plan-layout blocks for this rank's parts (leading axis =
    the rank's k = nparts / nranks parts, in part order)."""

    parts_lo: int
    ell_cols: np.ndarray  # (k, n_local, K) int32 extended-local columns
    ell_vals: np.ndarray  # (k, n_local, K)
    send_idx: np.ndarray  # (k, nparts, H) int32
    row_valid: np.ndarray  # (k, n_local) bool
    b_parts: np.ndarray  # (k, n_local)


def dist_pack_block(
    state: DistLocalState,
    rows: DistRankRows,
    H: int,
    K: int,
    dtype=np.float64,
) -> DistRankBlock:
    """Pack this rank's rows into the halo-plan block layout.

    Produces bit-identical slices of what :func:`.halo.build_halo_plan`
    would build from the global CSR: off-part columns map to
    ``n_local + q*H + slot`` with slot = rank of the column (ascending
    global id) within the unique (user p, owner q) column set; ``send_idx``
    comes from the structural-symmetry rule (see module docstring).
    """
    k = state.nparts // state.nranks
    parts_lo = state.rank * k
    n_local = state.n_local
    ell_cols = np.zeros((k, n_local, K), dtype=np.int32)
    ell_vals = np.zeros((k, n_local, K), dtype=np.dtype(dtype))
    send_idx = np.zeros((k, state.nparts, H), dtype=np.int32)
    row_valid = np.zeros((k, n_local), dtype=bool)
    b_parts = np.zeros((k, n_local), dtype=np.dtype(dtype))

    my = rows.my_rows
    if my.size:
        p_my = state.owner_free[my] - parts_lo
        l_my = state.local_of_row[my]
        row_valid[p_my, l_my] = True
        b_parts[p_my, l_my] = rows.b_local

        lens = rows.indptr[1:] - rows.indptr[:-1]
        rr = np.repeat(np.arange(my.size), lens)  # rank-local row per entry
        cols = rows.indices
        p_of_r = state.owner_free[my[rr]]  # global part of each entry's row
        p_of_c = state.owner_free[cols]
        off = p_of_r != p_of_c

        ext = np.empty(cols.size, dtype=np.int64)
        ext[~off] = state.local_of_row[cols[~off]]
        if off.any():
            # slot = rank within the sorted unique (p, q, col) group.
            key = (
                p_of_r[off].astype(np.int64) * state.nparts + p_of_c[off]
            ) * np.int64(state.n_free) + cols[off]
            tri, inv = np.unique(key, return_inverse=True)
            group = tri // np.int64(state.n_free)
            _, starts = np.unique(group, return_index=True)
            gstart = np.zeros(tri.size, dtype=np.int64)
            gstart[starts] = starts
            np.maximum.accumulate(gstart, out=gstart)
            slot = np.arange(tri.size) - gstart
            q = group % state.nparts
            ext[off] = n_local + q[inv] * H + slot[inv]

        slot_in_row = np.arange(cols.size) - np.repeat(rows.indptr[:-1], lens)
        ell_cols[p_my[rr], l_my[rr], slot_in_row] = ext.astype(np.int32)
        ell_vals[p_my[rr], l_my[rr], slot_in_row] = rows.data.astype(
            np.dtype(dtype)
        )

        # send_idx[p, q]: my p-owned rows that appear as columns in q's
        # rows == my rows referencing a q-owned column (structural
        # symmetry); ascending global row id == the receiver's ascending
        # needed-column order.
        if off.any():
            snd = np.unique(
                (p_of_r[off].astype(np.int64) * state.nparts + p_of_c[off])
                * np.int64(state.n_free)
                + my[rr][off]
            )
            sgroup = snd // np.int64(state.n_free)
            srow = snd % np.int64(state.n_free)
            _, sstarts = np.unique(sgroup, return_index=True)
            sg = np.zeros(snd.size, dtype=np.int64)
            sg[sstarts] = sstarts
            np.maximum.accumulate(sg, out=sg)
            sslot = np.arange(snd.size) - sg
            sp = sgroup // state.nparts - parts_lo
            sq = sgroup % state.nparts
            send_idx[sp, sq, sslot] = state.local_of_row[srow].astype(np.int32)

    return DistRankBlock(
        parts_lo=parts_lo,
        ell_cols=ell_cols,
        ell_vals=ell_vals,
        send_idx=send_idx,
        row_valid=row_valid,
        b_parts=b_parts,
    )


# ---------------------------------------------------------------------------
# In-process flavor (simulated ranks): the P-rank pipeline in one process
# ---------------------------------------------------------------------------


def assemble_heat_distributed(
    path: str,
    nranks: int,
    nparts: Optional[int] = None,
    dtype=np.float64,
    row_multiple: int = 8,
):
    """Run the full distributed pipeline with ``nranks`` simulated ranks.

    Returns ``(plan, b, state0)`` where ``plan`` is a :class:`.halo.HaloPlan`
    assembled WITHOUT ever building the global CSR and ``b`` is the global
    RHS (gathered from per-rank pieces, original free-row order).  Used by
    tests and the single-host CLI path; the real multi-process flavor is
    :func:`assemble_heat_multihost`.
    """
    nparts = nranks if nparts is None else nparts
    states = [
        dist_local_phase(path, r, nranks, nparts, row_multiple=row_multiple)
        for r in range(nranks)
    ]
    # The exchange: transpose the per-rank outboxes.
    rowsets = [
        dist_rank_rows(
            states[r], [states[s].send_keys[r] for s in range(nranks)], dtype=dtype
        )
        for r in range(nranks)
    ]
    H = max(rs.local_H for rs in rowsets)
    K = max(max(rs.local_K for rs in rowsets), 1)
    blocks = [
        dist_pack_block(states[r], rowsets[r], H, K, dtype=dtype)
        for r in range(nranks)
    ]

    st = states[0]
    perm = np.argsort(st.owner_free, kind="stable").astype(np.int64)
    plan = HaloPlan(
        nparts=nparts,
        n_global=st.n_free,
        n_local=st.n_local,
        halo_width=H,
        perm=perm,
        part_of_row=st.owner_free,
        local_of_row=st.local_of_row,
        ell_cols=np.concatenate([b.ell_cols for b in blocks]),
        ell_vals=np.concatenate([b.ell_vals for b in blocks]),
        send_idx=np.concatenate([b.send_idx for b in blocks]),
        row_valid=np.concatenate([b.row_valid for b in blocks]),
    )
    b_parts = np.concatenate([b.b_parts for b in blocks])
    b = plan.gather_vector(b_parts)
    return plan, b, st


# ---------------------------------------------------------------------------
# Real multi-process flavor: an all_to_all over torch.distributed
# ---------------------------------------------------------------------------


def multihost_exchange_keys(send_keys: List[np.ndarray], nranks: int):
    """All-to-all the per-destination key arrays across processes.

    The bulk edge redistribution, the analogue of the reference's element
    redistribution (``ExodusIO.hpp:989-1069``): every process's counts are
    gathered first, then one ``all_to_all`` of int64 buffers padded with
    -1 to the largest count.  Returns the received per-source key arrays
    for THIS rank."""
    if process_world() == 1:
        return [np.asarray(k) for k in send_keys]
    dev = comm_device()
    counts = torch.tensor([[k.size for k in send_keys]], dtype=torch.int64,
                          device=dev)
    W = max(int(gather_parts(counts).max()), 1)
    buf = np.full((nranks, W), -1, dtype=np.int64)
    for q, kq in enumerate(send_keys):
        buf[q, : kq.size] = kq
    local = exchange_rows(torch.from_numpy(buf).to(dev)).cpu().numpy()
    return [r[r >= 0] for r in local]


#: JAX's name: max-reduce a host scalar across processes (all-gather + max).
multihost_max_scalar = max_scalar


def assemble_heat_multihost(
    path: str,
    nparts: Optional[int] = None,
    dtype=np.float64,
    row_multiple: int = 8,
    device=None,
):
    """Fully distributed assembly across the ``torch.distributed``
    processes.

    Each process reads only its element slice, exchanges edge keys
    (:func:`multihost_exchange_keys`), assembles only its parts' rows, and
    uploads only its blocks (:func:`.multihost.put_global`).  Returns
    ``(op, b_sharded, plan, state)`` with ``op`` a
    :class:`.sharded.ShardedOperator` over the process mesh holding this
    process's parts and ``b_sharded`` its ``(k, n_local)`` right-hand
    side.  The returned ``plan``'s per-part arrays hold ONLY this rank's
    blocks; its global metadata (numbering, widths) is complete and
    identical on every rank.  ``device``: the mesh's (default the card).
    """
    from .multihost import put_global
    from .sharded import ShardedOperator, make_device_mesh

    nranks = process_world()
    rank = process_rank()
    nparts = nranks if nparts is None else nparts

    state = dist_local_phase(path, rank, nranks, nparts, row_multiple=row_multiple)
    recv = multihost_exchange_keys(state.send_keys, nranks)
    rows = dist_rank_rows(state, recv, dtype=dtype)
    H = multihost_max_scalar(rows.local_H)
    K = max(multihost_max_scalar(rows.local_K), 1)
    block = dist_pack_block(state, rows, H, K, dtype=dtype)

    mesh = make_device_mesh(nparts, None if device is None else [device])
    plan = HaloPlan(
        nparts=nparts,
        n_global=state.n_free,
        n_local=state.n_local,
        halo_width=H,
        perm=np.argsort(state.owner_free, kind="stable").astype(np.int64),
        part_of_row=state.owner_free,
        local_of_row=state.local_of_row,
        ell_cols=block.ell_cols,
        ell_vals=block.ell_vals,
        send_idx=block.send_idx,
        row_valid=block.row_valid,
    )
    op = ShardedOperator.from_plan(plan, mesh, dtype)
    b_sharded = put_global(block.b_parts.astype(np.dtype(dtype)), mesh)
    return op, b_sharded, plan, state
