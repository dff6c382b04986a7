"""Partitioned operators and solvers: one controller over P parts.

Counterpart of the JAX package's ``parallel/sharded.py``.  JAX runs the
domain-decomposed solve as one SPMD program under ``shard_map`` over a
1-D device mesh, with an ``all_to_all`` halo exchange and ``psum``-reduced
dots.  The port keeps the job and drops the SPMD layout: one process drives
all P parts of a :class:`HaloPlan` on one device (the card, or the CPU when
the caller asks for it), and

- a partitioned vector is a ``(P, n_local)`` tensor, the global view JAX
  gives of a ``P(AXIS)``-sharded array; ``put_vector`` / ``get_vector``
  keep JAX's contract through the plan's ``scatter_vector`` /
  ``gather_vector``;
- the collectives are explicit functions on those tensors, each in a fixed
  part order, so a solve is deterministic: the halo exchange
  (:func:`halo_exchange`, JAX's ``all_to_all``) is one gather over the
  flattened vector, ``halo[p, q, s] = x[q, send_idx[q, p, s]]``; the dot
  (:func:`psum_dot`, JAX's ``psum`` of per-part ``vdot``) takes each
  part's dot and adds them in part order; a part's dot is summed in
  tiles whose arithmetic does not depend on how many parts a process
  holds (:func:`part_sums`), so any number of processes gives the same
  bits;
- the Krylov loops (:func:`..solvers.cg.cg_solve` and the others) run
  unchanged over the ``(P, n_local)`` vectors, with that dot injected.

Two local products, as in JAX: :class:`ShardedOperator`'s padded ELL block
(plain XLA in JAX, plain PyTorch here: one batched gather through the
exchange and a row sum) and :class:`BSGShardedOperator`'s, which packs the
real rows of all of a process's parts as one sliced-ELL operator over the
vector they gather from and runs it on the sliced-ELL SpMV kernel
(``csrc/spmv.cu``), one launch per product in each process.  JAX runs one
kernel per device, each over its part's square block; one launch per part
on one card spent most of each launch on its latency and tail.

The mesh spans one device in each process.  JAX needs one device per
part; the card machine has one GPU.  With ``torch.distributed``
initialised over several processes (:mod:`.multihost`), each process holds
its own parts ``[rank*k, (rank+1)*k)`` on its own device as ``(k, ...)``
tensors.  The mesh says which: the collectives above take it, and talk
to the other processes (:mod:`.collectives`) only over a mesh of several
processes; with none, or a mesh of one, they run the one-controller code
whatever process group exists.  The Krylov loops run as they are, with the
mesh's dot (:meth:`DeviceMesh.dot`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..ops.bsg import BSGMatrix, bsg_from_csr, sell_operator
from ..ops.csr import CSRMatrix
from ..solvers.cg import CGResult, cg_solve, cg_solve_with_state
from ..solvers.gmres import GMRESResult, gmres_solve
from ..solvers.power import PowerResult, power_method
from ..solvers.precond.chebyshev import ChebyshevPreconditioner
from ..solvers.precond.jacobi import DiagonalPreconditioner
from ..utils.device import resolve_device
from .collectives import (
    exchange_rows,
    gather_parts,
    local_card,
    max_scalar,
    process_rank,
    process_world,
)
from .halo import HaloPlan

__all__ = [
    "AXIS",
    "BSGShardedOperator",
    "DeviceMesh",
    "ShardedOperator",
    "halo_exchange",
    "make_device_mesh",
    "part_sums",
    "part_tiles",
    "psum",
    "psum_dot",
    "sharded_cg_chunk",
    "sharded_cg_solve",
    "sharded_gmres_solve",
    "sharded_power_method",
]

AXIS = "parts"
_SPANS_DEVICES = ("one process drives one device: run a process per device "
                  "(parallel.multihost.initialize_multihost)")


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh of ``nparts`` parts along :data:`AXIS`.  Over ``world``
    processes, process ``rank`` holds the parts ``[parts_lo, parts_lo +
    local_parts)`` on ``device``; with one process, all of them."""

    nparts: int
    device: torch.device
    rank: int = 0
    world: int = 1

    @property
    def shape(self) -> dict:
        return {AXIS: self.nparts}

    @property
    def local_parts(self) -> int:
        return self.nparts // self.world

    @property
    def parts_lo(self) -> int:
        return self.rank * self.local_parts

    def local(self, arr):
        """This process's block of a part-major ``(nparts, ...)`` array
        (numpy or torch): its rows ``[parts_lo, parts_lo + local_parts)``,
        JAX's ``_local_rows``; the whole array with one process."""
        if arr.shape[0] != self.nparts:
            raise ValueError(f"an array of {arr.shape[0]} parts on a mesh "
                             f"of {self.nparts}")
        if self.world == 1:
            return arr
        return arr[self.parts_lo: self.parts_lo + self.local_parts]

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """:func:`psum_dot` over this mesh: the dot the Krylov loops take."""
        return psum_dot(a, b, self)

    def max(self, value: int) -> int:
        """The largest of every process's host ``value`` over this mesh: a
        decision every process takes alike."""
        return int(value) if self.world == 1 else max_scalar(value)


def _device_key(d) -> tuple:
    d = torch.device(d)
    return (d.type, d.index or 0)


def make_device_mesh(nparts: int,
                     devices: Optional[Sequence] = None) -> DeviceMesh:
    """The mesh of ``nparts`` parts, JAX's name (``sharded.py:45`` there).

    One process: every part lies on one device, ``devices[0]`` when a list
    is given, else the card (``resolve_device(None)``); unlike JAX's, this
    mesh always fits, however many parts it has.  With ``torch.distributed``
    initialised over ``world > 1`` processes: this process's ``nparts /
    world`` parts, on ``devices[0]`` or else the card
    :func:`.collectives.local_card` (its rank among the processes on its
    host modulo the host's cards); ``nparts % world != 0`` raises
    ``ValueError``, as JAX's ``_local_rows``.  A list that names two
    different devices raises ``NotImplementedError``: the port never
    places parts on devices silently."""
    if nparts < 1:
        raise ValueError(f"nparts must be >= 1, got {nparts}")
    world = process_world()
    if world > 1 and nparts % world:
        raise ValueError(f"nparts={nparts} not divisible by {world} processes")
    rank = process_rank()
    if devices is None:
        dev = None
        if world > 1 and torch.cuda.is_available():
            dev = torch.device("cuda", local_card())
        return DeviceMesh(nparts, resolve_device(dev), rank, world)
    devs = list(devices)[:nparts]
    if not devs:
        raise ValueError("devices is empty")
    if len({_device_key(d) for d in devs}) > 1:
        raise NotImplementedError(
            f"devices {[str(d) for d in devs]}: {_SPANS_DEVICES}")
    return DeviceMesh(nparts, resolve_device(devs[0]), rank, world)


# ---------------------------------------------------------------------------
# The collectives, on (P, n_local) tensors (across processes: (k, n_local))
# ---------------------------------------------------------------------------


def part_blocks(plan: HaloPlan, mesh: DeviceMesh) -> tuple:
    """``(ell_cols, ell_vals, send_idx)`` of the mesh's local parts: cut
    from a plan that holds all P parts' blocks, or taken whole from a plan
    that holds only this process's
    (:func:`.distassembly.assemble_heat_multihost`)."""
    blocks = (plan.ell_cols, plan.ell_vals, plan.send_idx)
    held = plan.ell_cols.shape[0]
    if held == plan.nparts:
        return tuple(mesh.local(a) for a in blocks)
    if held != mesh.local_parts:
        raise ValueError(f"a plan holding {held} of {plan.nparts} parts' "
                         f"blocks on a process of {mesh.local_parts}")
    return blocks


def halo_index(plan: HaloPlan, mesh: Optional[DeviceMesh] = None
               ) -> np.ndarray:
    """One process: ``(P, P*H)`` int64, the position in the flattened
    ``(P, n_local)`` vector of every halo slot, ``[p, q*H + s] =
    q*n_local + send_idx[q, p, s]`` (JAX's ``take`` of the send buffer and
    ``all_to_all``).  Across processes: ``(k, P, H)``, the position in the
    flattened local ``(k, n_local)`` vector of every value a local part
    sends, ``[p, q, s] = p*n_local + send_idx[p, q, s]``."""
    P_, H, n = plan.nparts, plan.halo_width, plan.n_local
    if mesh is not None and mesh.world > 1:
        send = part_blocks(plan, mesh)[2].astype(np.int64)
        return send + n * np.arange(send.shape[0], dtype=np.int64)[
            :, None, None]
    src = plan.send_idx.astype(np.int64).transpose(1, 0, 2)  # [p, q, s]
    return (src + n * np.arange(P_, dtype=np.int64)[None, :, None]
            ).reshape(P_, P_ * H)


def across_processes(values: torch.Tensor,
                     mesh: Optional[DeviceMesh]) -> bool:
    """Whether a collective over ``mesh`` crosses processes; over several,
    ``values`` must hold the mesh's local parts."""
    if mesh is None or mesh.world == 1:
        return False
    if values.shape[0] != mesh.local_parts:
        raise ValueError(f"{values.shape[0]} parts on a process holding "
                         f"{mesh.local_parts}")
    return True


def all_parts(values: torch.Tensor,
              mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Every part's ``values`` (leading axis): over a ``mesh`` of several
    processes the local parts' gathered from every process, in part order
    (every process calls it); else ``values`` itself."""
    return gather_parts(values) if across_processes(values, mesh) else values


def halo_exchange(x: torch.Tensor, index: torch.Tensor,
                  mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """``x (P, n_local)`` -> ``halo (P, P*H)``: part p's halo, the values
    its columns read from the other parts (``index`` from
    :func:`halo_index`).  One gather.

    Over a ``mesh`` of several processes ``x`` is ``(k, n_local)`` and
    ``index`` ``(k, P, H)``: the local send buffers, one ``all_to_all``
    between the processes, and each local part's ``(P*H)`` halo in the
    same order."""
    if not across_processes(x, mesh):
        return x.reshape(-1)[index]
    k, P_, H = index.shape
    w = P_ // k
    send = x.reshape(-1)[index].view(k, w, k, H).permute(1, 0, 2, 3)
    recv = exchange_rows(send)  # [source process, its part, my part, s]
    return recv.permute(2, 0, 1, 3).reshape(k, P_ * H)


def psum(values: torch.Tensor,
         mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Sum of per-part values (leading axis) added in part order:
    ``((v0 + v1) + v2) + ...``, JAX's ``psum`` with a fixed order.  Over a
    ``mesh`` of several processes ``values`` holds the local parts': every
    part's value is gathered first, so every process adds the same P
    values alike."""
    values = all_parts(values, mesh)
    total = values[0]
    for p in range(1, values.shape[0]):
        total = total + values[p]
    return total


# Values per partial sum of :func:`part_tiles`: one warp's lanes.  CUDA's
# reduction gives a row of at most 32 values to one warp of 32 lanes and
# adds it in the warp's fixed shuffle order, whatever the number of rows.
TILE = 32


def part_tiles(values: torch.Tensor) -> torch.Tensor:
    """``(k, n)`` -> ``(k, ceil(n / TILE))``: each part's row cut into
    tiles of :data:`TILE` contiguous values (zeros past ``n``), each tile
    summed alone.  A part's tiles depend on its own row only, not on how
    many parts ``values`` holds: a ``(k, n)`` row sum need not, since
    CUDA's reduction splits a row by the whole shape."""
    k, n = values.shape
    pad = -n % TILE
    if pad:
        values = torch.nn.functional.pad(values, (0, pad))
    return values.reshape(k, -1, TILE).sum(dim=2)


def part_sums(values: torch.Tensor,
              mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Every part's sum of ``values`` (``(P, n)``; over a ``mesh`` of
    several processes the local ``(k, n)``): ``(P,)`` on every process.
    The :func:`part_tiles` of every part are gathered and summed as one
    ``(P, ceil(n / TILE))`` tensor, the same shape in one process as in
    many, so each part's sum is the same bits for any number of
    processes."""
    return all_parts(part_tiles(values), mesh).sum(dim=1)


def psum_dot(a: torch.Tensor, b: torch.Tensor,
             mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """The global dot of two ``(P, n_local)`` vectors: each part's dot
    (:func:`part_sums`), then :func:`psum` in part order (JAX's
    ``_psum_dot``), the same bits over any number of processes."""
    return psum(part_sums(a * b, mesh))


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedOperator:
    """A partitioned sparse operator: each part's ELL block over its
    extended-local space ``[x_own (n_local) | halo (P*H)]``, and the
    exchange plan.  ``matvec`` takes and returns ``(P, n_local)``; over a
    mesh of several processes the operator holds its local parts only
    (``(k, ...)`` tensors) and runs the halo exchange across them
    (:meth:`source`)."""

    mesh: DeviceMesh
    plan: HaloPlan
    cols: torch.Tensor  # (P, n_local, K) int64 extended-local columns
    vals: torch.Tensor  # (P, n_local, K)
    halo_idx: torch.Tensor  # halo_index(plan, mesh)
    flat_cols: torch.Tensor  # (P, n_local*K) int64: cols through the exchange

    @classmethod
    def from_plan(cls, plan: HaloPlan, mesh: DeviceMesh,
                  dtype=None) -> "ShardedOperator":
        """Upload the plan's blocks of the mesh's parts to ``mesh.device``;
        values in ``dtype`` (numpy or torch; default the plan's)."""
        return cls(**_base_fields(plan, mesh, dtype))

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def nparts(self) -> int:
        return self.plan.nparts

    @property
    def n_local(self) -> int:
        return self.plan.n_local

    def put_vector(self, x_global) -> torch.Tensor:
        """Host ``(n_global,)`` -> ``(P, n_local)`` (across processes this
        process's ``(k, n_local)``) in the operator's dtype on its device
        (zeros on padding rows)."""
        xp = self.mesh.local(self.plan.scatter_vector(
            np.asarray(x_global, dtype=_np_dtype(self.dtype))))
        return torch.from_numpy(np.ascontiguousarray(xp)).to(self.device)

    def get_vector(self, x: torch.Tensor) -> np.ndarray:
        """``(P, n_local)`` -> host ``(n_global,)`` in original row order
        (across processes every process's parts are gathered first: every
        process calls it)."""
        return self.plan.gather_vector(
            all_parts(x.detach(), self.mesh).cpu().numpy())

    def diagonal(self) -> torch.Tensor:
        """The diagonal of the held parts' rows, ``(P, n_local)`` (across
        processes ``(k, n_local)``), 0 on padding rows: the Jacobi
        preconditioner of a system whose global matrix no process holds
        (:func:`.distassembly.assemble_heat_multihost`)."""
        own = torch.arange(self.n_local, device=self.device)[None, :, None]
        return (self.vals * (self.cols == own)).sum(dim=2)

    def source(self, x: torch.Tensor) -> torch.Tensor:
        """The flattened vector the local products gather from: ``x``
        itself on one process; across processes ``x`` then every local
        part's halo from :func:`halo_exchange`."""
        if self.mesh.world == 1:
            return x.reshape(-1)
        return torch.cat([x.reshape(-1), halo_exchange(
            x, self.halo_idx, self.mesh).reshape(-1)])

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``y = A x`` over the parts: every part's ELL row sum over its
        extended-local vector.  With one process the exchange and the
        column gather are composed into one gather (``flat_cols``); across
        processes ``flat_cols`` indexes ``[x | halo]``.  The products and
        their order are JAX's ``_local_spmv``."""
        P_, n, K = self.cols.shape
        xg = self.source(x)[self.flat_cols].view(P_, n, K)
        return (self.vals * xg).sum(dim=2)


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).replace("torch.", ""))
    return np.dtype(dtype)


def _halo_positions(plan: HaloPlan, mesh: DeviceMesh,
                    hidx: np.ndarray) -> np.ndarray:
    """``(k, P*H)``: where each local part's halo slots lie in
    :meth:`ShardedOperator.source`'s vector (one process: ``hidx`` itself,
    positions in ``x``; across processes after the ``k*n_local`` own
    values)."""
    if mesh.world == 1:
        return hidx
    k, PH = mesh.local_parts, plan.nparts * plan.halo_width
    return k * plan.n_local + np.arange(k * PH, dtype=np.int64).reshape(k, PH)


def _base_fields(plan: HaloPlan, mesh: DeviceMesh, dtype) -> dict:
    if mesh.nparts != plan.nparts:
        raise ValueError(f"mesh of {mesh.nparts} parts for a plan of "
                         f"{plan.nparts}")
    dev = mesh.device
    ell_cols, ell_vals = part_blocks(plan, mesh)[:2]
    vals = ell_vals if dtype is None else ell_vals.astype(_np_dtype(dtype))
    hidx = halo_index(plan, mesh)
    halo_pos = _halo_positions(plan, mesh, hidx)
    n, k = plan.n_local, ell_cols.shape[0]
    cols = ell_cols.astype(np.int64)
    own = n * np.arange(k, dtype=np.int64)[:, None, None] + cols
    flat = np.where(
        cols < n, own,
        np.take_along_axis(halo_pos, np.maximum(cols - n, 0).reshape(
            k, -1), axis=1).reshape(cols.shape))
    return dict(
        mesh=mesh,
        plan=plan,
        cols=torch.from_numpy(cols).to(dev),
        vals=torch.from_numpy(np.ascontiguousarray(vals)).to(dev),
        halo_idx=torch.from_numpy(hidx).to(dev),
        flat_cols=torch.from_numpy(flat.reshape(k, -1)).to(dev),
    )


def _bsg_storage(vals: np.ndarray, mesh: DeviceMesh) -> str:
    """JAX's rule for the sharded blocks (``sharded.py:127-137`` there),
    decided once on the global values so every part stores alike:
    bfloat16 when every value survives it, else float32.  Across processes
    each holds its parts' values, and the processes agree on the rule."""
    from ..ops.dia import _bf16_exact

    inexact = mesh.max(not _bf16_exact(np.asarray(vals).ravel()))
    return "float32" if inexact else "bfloat16"


def part_block_csr(plan: HaloPlan, p: int) -> CSRMatrix:
    """Part ``p``'s block as a square CSR over its extended-local space
    (``n_local + P*H`` rows and columns; the halo rows are empty), from
    the plan's nonzero ELL slots, as JAX builds it."""
    return _block_csr(plan.ell_cols[p], plan.ell_vals[p],
                      plan.n_local + plan.nparts * plan.halo_width)


def _block_csr(cols: np.ndarray, vals: np.ndarray, n_ext: int) -> CSRMatrix:
    n_local, K = cols.shape
    cols = np.asarray(cols)
    vals = np.asarray(vals, dtype=np.float64)
    rows = np.repeat(np.arange(n_local), K)
    nz = vals.reshape(-1) != 0
    r, c, v = rows[nz], cols.reshape(-1)[nz], vals.reshape(-1)[nz]
    o = np.lexsort((c, r))
    r, c, v = r[o], c[o], v[o]
    indptr = np.zeros(n_ext + 1, np.int64)
    np.add.at(indptr, r + 1, 1)
    return CSRMatrix(indptr=np.cumsum(indptr), indices=c.astype(np.int64),
                     data=v, shape=(n_ext, n_ext))


def _stacked_csr(ell_cols: np.ndarray, ell_vals: np.ndarray,
                 flat: np.ndarray) -> tuple:
    """CSR arrays ``(indptr, indices, data)`` of the local parts' real rows
    stacked, part after part (``k * n_local`` rows): each row's nonzero
    slots in :func:`_block_csr`'s order (ascending extended-local column),
    each column mapped to its position in :meth:`ShardedOperator.source`'s
    vector (``flat``, the ``flat_cols`` of :func:`_base_fields`)."""
    k, n, K = ell_cols.shape
    cols = ell_cols.reshape(k * n, K)
    order = np.argsort(cols, axis=1, kind="stable")
    vals = np.take_along_axis(np.asarray(ell_vals, dtype=np.float64).reshape(
        k * n, K), order, axis=1)
    pos = np.take_along_axis(flat.reshape(k * n, K), order, axis=1)
    nz = vals != 0
    indptr = np.zeros(k * n + 1, dtype=np.int64)
    np.cumsum(nz.sum(axis=1), out=indptr[1:])
    return indptr, pos[nz], vals[nz]


@dataclasses.dataclass
class BSGShardedOperator(ShardedOperator):
    """A partitioned operator whose local products run on the sliced-ELL
    SpMV kernel, one launch per product in each process: ``local`` holds
    the real rows of every local part, ``k * n_local`` of them part after
    part (no halo rows, no padding per part: a 32-row slice may straddle
    two parts), as one sliced-ELL operator whose columns are positions in
    :meth:`source`'s vector (one process: ``x`` itself; across processes
    ``[x | halo]``).  A row's slots keep the
    order of its part's block (ascending extended-local column, as JAX
    packs the block), values in one storage for all parts
    (:func:`_bsg_storage`).

    ``matvec``: one launch reads :meth:`source`'s vector and writes the
    ``(k, n_local)`` answer in place: no gather of extended vectors, no
    slicing, no stack.  A row's sum is the one its part's block alone
    gives (:attr:`parts`, :meth:`extended`), bit for bit."""

    local: Optional[BSGMatrix] = None  # (k * n_local) rows over source(x)
    _parts: Optional[List[BSGMatrix]] = dataclasses.field(default=None,
                                                          repr=False)
    _ext_idx: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                         repr=False)

    @classmethod
    def from_plan(cls, plan: HaloPlan, mesh: DeviceMesh,
                  dtype=None) -> "BSGShardedOperator":
        base = _base_fields(plan, mesh, dtype)
        ell_cols, ell_vals = part_blocks(plan, mesh)[:2]
        storage = _bsg_storage(ell_vals, mesh)
        n, k = plan.n_local, ell_cols.shape[0]
        n_x = k * n + (0 if mesh.world == 1
                       else k * plan.nparts * plan.halo_width)
        indptr, indices, data = _stacked_csr(
            ell_cols, ell_vals, base["flat_cols"].cpu().numpy())
        local = sell_operator(indptr, indices, data, n_x, storage=storage,
                              device=mesh.device)
        return cls(**base, local=local)

    @property
    def parts(self) -> List[BSGMatrix]:
        """Each local part's block alone over its extended-local space
        (``n_local + P*H`` rows and columns padded to a multiple of 1024;
        the halo rows and the padding are slices of width 0), in the
        stacked operator's storage, packed on first use: the per-part
        operator that :attr:`local` stacks, for checks (the products never
        use it)."""
        if self._parts is None:
            ell_cols, ell_vals = part_blocks(self.plan, self.mesh)[:2]
            n_ext = self.n_local + self.nparts * self.plan.halo_width
            self._parts = [
                bsg_from_csr(_block_csr(c, v, n_ext), reorder=False,
                             storage=self.local.storage, layout="dense",
                             device=self.device)
                for c, v in zip(ell_cols, ell_vals)]
        return self._parts

    def extended(self, x: torch.Tensor) -> torch.Tensor:
        """``(k, n_pad)``: each local part's own values, its halo, then
        zeros -- the input of its block alone (:attr:`parts`)."""
        if self._ext_idx is None:
            n_pad, n, k = self.parts[0].n_pad, self.n_local, self.cols.shape[0]
            halo_pos = _halo_positions(self.plan, self.mesh,
                                       self.halo_idx.cpu().numpy())
            ext = np.full((k, n_pad), self.local.x_len, dtype=np.int64)
            ext[:, :n] = (n * np.arange(k, dtype=np.int64)[:, None]
                          + np.arange(n, dtype=np.int64)[None, :])
            ext[:, n: n + halo_pos.shape[1]] = halo_pos
            self._ext_idx = torch.from_numpy(ext).to(self.device)
        xz = torch.cat([self.source(x), x.new_zeros(1)])
        return xz[self._ext_idx]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.local.matvec(self.source(x)).view(x.shape)


# ---------------------------------------------------------------------------
# Solvers: the single-device loops over (P, n_local) vectors, the mesh's dot
# ---------------------------------------------------------------------------


def _diag_precond(op, b, precond_diag, cheb_lmax, cheb_degree):
    if precond_diag is None:
        return None
    if cheb_lmax is not None:
        # Each polynomial term is a halo-exchange product.
        return ChebyshevPreconditioner(
            A=op, inv_diag=precond_diag,
            lmax=torch.tensor(cheb_lmax, dtype=b.dtype), degree=cheb_degree,
        )
    return DiagonalPreconditioner(precond_diag)


def sharded_cg_solve(
    op: ShardedOperator,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    precond_diag: Optional[torch.Tensor] = None,
    cheb_lmax: Optional[float] = None,
    cheb_degree: int = 4,
    block_amg: Optional[Callable] = None,
    coarse_inv: Optional[torch.Tensor] = None,
    row_valid: Optional[torch.Tensor] = None,
    tol: float = 1e-14,
    maxiter: int = 300,
) -> CGResult:
    """CG over the parts (JAX's ``sharded_cg_solve``), preconditioned by:

    - Jacobi, ``precond_diag`` (the inverse diagonal, ``(P, n_local)``);
    - Chebyshev with it, ``cheb_lmax`` (each term a halo-exchange product);
    - block-Schwarz, ``block_amg``: a per-part preconditioner applied to
      every part's residual with no communication —
      :func:`.schwarz.build_block_amg` or :func:`.schwarzilu.build_block_ilu`
      (it replaces Jacobi, as in JAX);
    - ``coarse_inv`` + ``row_valid`` (:func:`.schwarz.build_coarse_correction`,
      the plan's ``row_valid`` of the mesh's parts) add the
      partition-constant coarse correction: two-level Schwarz
      (:class:`.schwarz.TwoLevelPrecond`).

    Over a mesh of several processes every vector and per-part
    preconditioner holds this process's parts (build them with ``mesh=``)."""
    M = _diag_precond(op, b, precond_diag, cheb_lmax, cheb_degree)
    if block_amg is not None:
        M = block_amg
    if coarse_inv is not None:
        from .schwarz import TwoLevelPrecond

        if M is None:
            M = DiagonalPreconditioner(torch.ones_like(b))
        M = TwoLevelPrecond(local=M, Ac_inv=coarse_inv, valid=row_valid,
                            mesh=op.mesh)
    return cg_solve(op, b, x0, precond=M, tol=tol, maxiter=maxiter,
                    dot=op.mesh.dot)


def sharded_cg_chunk(
    op: ShardedOperator,
    b: torch.Tensor,
    x: torch.Tensor,
    state,
    *,
    precond_diag: Optional[torch.Tensor] = None,
    cheb_lmax: Optional[float] = None,
    cheb_degree: int = 4,
    tol: float = 1e-14,
    maxiter: int = 50,
):
    """One chunk of partitioned CG, continuing exactly from ``state``
    (``None`` or the ``(r, p, rz)`` of the previous chunk).  Returns
    ``(CGResult, new_state)``; chunks driven in a host loop run the
    unbroken solve's recurrence bit for bit."""
    M = _diag_precond(op, b, precond_diag, cheb_lmax, cheb_degree)
    return cg_solve_with_state(op, b, x, state=state, precond=M, tol=tol,
                               maxiter=maxiter, dot=op.mesh.dot)


def sharded_gmres_solve(
    op: ShardedOperator,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    precond_diag: Optional[torch.Tensor] = None,
    block_precond: Optional[Callable] = None,
    restart: int = 30,
    tol: float = 1e-14,
    maxiter: int = 300,
) -> GMRESResult:
    """GMRES(m) over the parts — the reference's solver (Belos "GMRES",
    ``BelosMueLuSolver.cpp:105-106``) distributed.  ``block_precond``: a
    per-part preconditioner such as :func:`.schwarzilu.build_block_ilu`,
    which makes this the reference's ``mpirun`` configuration: GMRES with
    per-rank ILUT."""
    M = DiagonalPreconditioner(precond_diag) if precond_diag is not None \
        else None
    if block_precond is not None:
        M = block_precond
    return gmres_solve(op, b, x0, precond=M, restart=restart, tol=tol,
                       maxiter=maxiter, dot=op.mesh.dot)


def sharded_power_method(
    op: ShardedOperator,
    z0: torch.Tensor,
    *,
    maxiter: int = 500,
    tol: float = 1e-2,
    check_every: int = 50,
) -> PowerResult:
    """The power method over the parts — ``ExodusMatrixTest`` under
    ``mpirun`` (``ExodusMatrixTest.cpp:131-171``)."""
    return power_method(op, z0, maxiter=maxiter, tol=tol,
                        check_every=check_every, dot=op.mesh.dot)
