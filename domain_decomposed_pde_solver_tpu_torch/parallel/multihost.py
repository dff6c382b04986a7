"""Multi-process execution: start-up, per-process placement, the slab CG
across processes and sharded checkpoints.

Counterpart of the JAX package's ``parallel/multihost.py``.  The
reference runs under ``mpirun -n K``, every rank entering SPMD at
``Tpetra::ScopeGuard`` (``BelosMueLuSolver.cpp:142``); JAX starts its
distributed runtime against a coordinator and runs the same ``shard_map``
programs over every process's devices.  The port starts
``torch.distributed`` and runs the same one-controller programs in every
process, each over its own parts (:mod:`.collectives`):

- :func:`initialize_multihost` -- the process group from arguments or
  JAX's ``DDPS_*`` environment variables, with the backend chosen by an
  explicit rule (:func:`choose_backend`);
- :func:`put_global` -- this process's rows on its device: no process
  uploads data it does not own (the reference's block element
  distribution, ``ExodusIO.hpp:781-828``);
- :func:`multihost_slab_cg_solve` -- the slab CG with per-process
  placement and the full answer on every process;
- :func:`save_sharded_checkpoint` / :func:`load_sharded_checkpoint` --
  each process writes only its parts, in JAX's file format.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .collectives import process_rank, staged

__all__ = [
    "choose_backend",
    "initialize_multihost",
    "put_global",
    "multihost_slab_cg_solve",
    "save_sharded_checkpoint",
    "load_sharded_checkpoint",
]

log = logging.getLogger(__name__)


def choose_backend(num_processes: int, requested: Optional[str] = None,
                   device: Optional[str] = None) -> str:
    """The process group's backend: NCCL when every process has a card of
    its own (the processes on one host), gloo when processes share a card
    (NCCL refuses two ranks on one GPU) or compute on the CPU
    (``device="cpu"``, or no card).  A ``requested`` backend is checked
    against the rule: NCCL where it cannot run raises ``ValueError``."""
    cpu = (device is not None and torch.device(device).type == "cpu") \
        or not torch.cuda.is_available()
    cards = 0 if cpu else torch.cuda.device_count()
    rule = "nccl" if not cpu and num_processes <= cards else "gloo"
    if requested is not None and requested != rule:
        if requested == "nccl":
            raise ValueError(
                f"nccl needs a card for each process: {num_processes} "
                f"processes, {cards} card(s)")
        if requested != "gloo":
            raise ValueError(f"unknown backend {requested!r}")
        rule = requested
    return rule


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: Optional[str] = None,
    timeout_s: float = 600.0,
) -> int:
    """Start this process's ``torch.distributed`` group; returns its rank.

    Arguments default to the ``DDPS_COORDINATOR`` / ``DDPS_NUM_PROCESSES``
    / ``DDPS_PROCESS_ID`` environment variables, JAX's (set them per
    process like MPI ranks).  Nothing on a GPU machine tells a program of
    a cluster, so all three must be given one way or the other.  The
    address is ``host:port`` (taken as ``tcp://host:port``) or any
    ``torch.distributed`` URL (``tcp://``, ``file://``).  ``backend``:
    :func:`choose_backend`'s rule, logged; ``device="cpu"`` for processes
    that compute on the CPU.  A collective that waits longer than
    ``timeout_s`` for another process raises."""
    coordinator_address = coordinator_address or os.environ.get(
        "DDPS_COORDINATOR")
    if num_processes is None and "DDPS_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DDPS_NUM_PROCESSES"])
    if process_id is None and "DDPS_PROCESS_ID" in os.environ:
        process_id = int(os.environ["DDPS_PROCESS_ID"])
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "initialize_multihost needs the coordinator's address, the "
            "number of processes and this process's id (arguments or "
            "DDPS_COORDINATOR, DDPS_NUM_PROCESSES, DDPS_PROCESS_ID)")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    chosen = choose_backend(num_processes, backend, device)
    if chosen == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        chosen, init_method=url, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    cuda = torch.cuda.is_available() and (
        device is None or torch.device(device).type == "cuda")
    log.info(
        "process %d of %d: backend %s (%s)%s", process_id, num_processes,
        chosen, "a card per process" if chosen == "nccl" else
        "processes share a card" if cuda else "processes on the CPU",
        "; tensors on the card are staged through host memory for every "
        "collective" if cuda and staged(torch.device("cuda")) else "")
    return dist.get_rank()


def put_global(local, mesh) -> torch.Tensor:
    """This process's block of a part-major array on the mesh's device:
    ``local`` holds the rows of the leading (part) axis this process owns,
    in part order (JAX: ``make_array_from_process_local_data``; with one
    process, the whole array)."""
    return torch.as_tensor(np.ascontiguousarray(local)).to(mesh.device)


def multihost_slab_cg_solve(plan, b: np.ndarray, x0: np.ndarray, *,
                            tol: float = 1e-12, maxiter: int = 1000,
                            jacobi: bool = True, mesh=None):
    """The slab CG across every process's parts, JAX's name and contract:
    :func:`.slab.slab_cg_solve` over ``mesh`` (default
    :func:`.sharded.make_device_mesh`, this process's parts on the card),
    each process uploading only its slabs and getting the full host answer
    back.  Returns ``(x_host, CGResult)``, the result's ``x`` this
    process's ``(k, slab)`` iterate."""
    from .slab import slab_cg_solve

    return slab_cg_solve(plan, b, x0, mesh=mesh, tol=tol, maxiter=maxiter,
                         jacobi=jacobi)


def save_sharded_checkpoint(path_prefix: str, arrays: dict) -> str:
    """Write this process's parts of each array to
    ``{path_prefix}.proc{pid}.npz`` in JAX's format: a tensor is this
    process's rows of a part-major array (``(k, ...)``, starting at row
    ``pid*k``), stored one part per key ``name__{row}`` as JAX stores one
    device's shard; any other array is whole, written by process 0 only.
    Checkpoint IO scales with the processes (no gather)."""
    pid = process_rank()
    out = {}
    for name, arr in arrays.items():
        if isinstance(arr, torch.Tensor):
            blk = arr.detach().cpu().numpy()
            lo = pid * blk.shape[0]
            for i in range(blk.shape[0]):
                out[f"{name}__{lo + i}"] = blk[i: i + 1]
        elif pid == 0:
            out[name] = np.asarray(arr)
    path = f"{path_prefix}.proc{pid}.npz"
    np.savez(path, **out)
    return path


def load_sharded_checkpoint(path_prefix: str) -> dict:
    """Load this process's file (the port's or JAX's); returns ``{name:
    {row_start: block}}`` for sharded arrays and ``{name: array}`` for
    whole ones."""
    path = f"{path_prefix}.proc{process_rank()}.npz"
    with np.load(path) as z:
        out: dict = {}
        for key in z.files:
            if "__" in key:
                name, start = key.rsplit("__", 1)
                out.setdefault(name, {})[int(start)] = z[key]
            else:
                out[key] = z[key]
    return out
