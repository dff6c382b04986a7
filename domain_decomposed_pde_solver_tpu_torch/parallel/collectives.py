"""The collectives across processes: the process layout of the
partitioned solve over ``torch.distributed``.

JAX runs its ``shard_map`` programs across processes unchanged
(``multihost.py:1-26`` there): the mesh spans every process's devices and
the collectives ride the interconnect.  The port's programs are the
``(P, n_local)`` and ``(P, slab)`` tensors of one controller
(``sharded.py``, ``slab.py``).  Over a mesh of ``world > 1`` processes
(:func:`.sharded.make_device_mesh` once ``torch.distributed`` is
initialised), process ``rank`` holds the parts ``[rank*k, (rank+1)*k)``,
``k = P / world`` (JAX's process-major order), as a ``(k, ...)`` tensor
in the same place, and the three collectives of those programs, given
that mesh, take the local tensor and talk to the other processes:

- the sum of per-part values (:func:`.sharded.psum`): :func:`gather_parts`
  brings every part's partial to every process, which then adds all P in
  part order, so each process gets the one-process scalar of the same
  partials;
- the halo exchange (:func:`.sharded.halo_exchange`): :func:`exchange_rows`
  is one ``all_to_all`` of the ``(k, P, H)`` send buffers, JAX's
  ``all_to_all`` (``sharded.py:225-227`` there);
- the slab ring (:func:`.slab.neighbour_strips`): :func:`ring_strips`
  sends this process's first strip back and its last strip on, and
  receives the neighbours' (JAX's two ``ppermute`` shifts), zeros at the
  ring ends.

The mesh decides, not the process group: without a mesh, or over a mesh
of one process, none of this runs and the callers keep their
one-controller code, whatever group exists.

The backend is :func:`..parallel.multihost.initialize_multihost`'s: NCCL
when every process has a card of its own, gloo when processes share a card
(NCCL refuses two ranks on one GPU) or compute on the CPU.  Over gloo,
tensors on a card are staged through host memory here, always: the copy to
the host and back is explicit, and the arithmetic stays on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

__all__ = [
    "comm_device",
    "exchange_rows",
    "gather_parts",
    "max_scalar",
    "process_rank",
    "process_world",
    "ring_strips",
    "staged",
]


def process_world() -> int:
    """Processes in the default group; 1 when ``torch.distributed`` is not
    initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_rank() -> int:
    """This process's rank in the default group; 0 when not initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def staged(device: torch.device) -> bool:
    """Whether a collective on tensors of ``device`` goes through host
    memory: a card's tensors over gloo."""
    return torch.device(device).type == "cuda" and dist.get_backend() == "gloo"


def comm_device() -> torch.device:
    """Where host data (numpy) is put to be exchanged: this process's card
    over NCCL, the CPU over gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _out(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.cpu() if staged(t.device) else t


def gather_parts(local: torch.Tensor) -> torch.Tensor:
    """``(k, ...)`` on every process -> ``(world*k, ...)``, the processes'
    rows in rank order, on ``local``'s device (``all_gather``)."""
    src = _out(local)
    rows = [torch.empty_like(src) for _ in range(process_world())]
    dist.all_gather(rows, src)
    return torch.cat(rows).to(local.device)


def exchange_rows(send: torch.Tensor) -> torch.Tensor:
    """``(world, ...)`` -> ``(world, ...)``: row ``r`` of ``send`` goes to
    process ``r``, row ``s`` of the result came from process ``s``
    (``all_to_all``)."""
    src = _out(send)
    recv = torch.empty_like(src)
    dist.all_to_all_single(recv, src)
    return recv.to(send.device)


def ring_strips(first: torch.Tensor,
                last: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """This process's first strip goes to the previous process and its
    last strip to the next; returns ``(from_previous, from_next)``, the
    previous process's last strip and the next one's first, zeros at the
    ring ends (point-to-point sends and receives)."""
    r, w = process_rank(), process_world()
    first, last = _out(first), _out(last)
    from_prev = torch.zeros_like(last)
    from_next = torch.zeros_like(first)
    ops = []
    if r > 0:
        ops += [dist.P2POp(dist.isend, first, r - 1),
                dist.P2POp(dist.irecv, from_prev, r - 1)]
    if r < w - 1:
        ops += [dist.P2POp(dist.isend, last, r + 1),
                dist.P2POp(dist.irecv, from_next, r + 1)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_prev, from_next


def max_scalar(value: int) -> int:
    """The largest of every process's ``value`` (``value`` itself with one
    process)."""
    if process_world() == 1:
        return int(value)
    vals = gather_parts(torch.tensor([int(value)], dtype=torch.int64,
                                     device=comm_device()))
    return int(vals.max())
