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
- :func:`launcher_settings`, :func:`launch_refusal` and :func:`launched`
  -- the group a launcher
  (torchrun, or the ``DDPS_*`` variables set per process) asks a driver
  to join, and the driver's run in it: this process's card, process 0
  alone printing;
- :func:`put_global` -- this process's rows on its device: no process
  uploads data it does not own (the reference's block element
  distribution, ``ExodusIO.hpp:781-828``);
- :func:`multihost_slab_cg_solve` -- the slab CG with per-process
  placement and the full answer on every process;
- :func:`save_sharded_checkpoint` / :func:`load_sharded_checkpoint` --
  each process writes only its parts, in JAX's file format.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .collectives import local_card, local_processes, process_rank, staged

__all__ = [
    "choose_backend",
    "initialize_multihost",
    "launch_refusal",
    "launched",
    "launcher_settings",
    "put_global",
    "multihost_slab_cg_solve",
    "save_sharded_checkpoint",
    "load_sharded_checkpoint",
]

log = logging.getLogger(__name__)


def choose_backend(num_processes: int, requested: Optional[str] = None,
                   device: Optional[str] = None) -> str:
    """The process group's backend: NCCL when every process on this host
    has a card of its own, gloo when processes on a host share a card
    (NCCL refuses two ranks on one GPU) or compute on the CPU
    (``device="cpu"``, or no card).  The processes on this host are
    :func:`.collectives.local_processes`'s (``LOCAL_WORLD_SIZE``, else all
    ``num_processes``), so one process per host across hosts runs NCCL.  A
    ``requested`` backend is checked against the rule: NCCL where it cannot
    run raises ``ValueError``."""
    local_world = local_processes(num_processes)[1]
    cpu = (device is not None and torch.device(device).type == "cpu") \
        or not torch.cuda.is_available()
    cards = 0 if cpu else torch.cuda.device_count()
    rule = "nccl" if not cpu and local_world <= cards else "gloo"
    if requested is not None and requested != rule:
        if requested == "nccl":
            raise ValueError(
                f"nccl needs a card for each process on this host: "
                f"{local_world} local processes, {cards} card(s)")
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
    :func:`choose_backend`'s rule for the processes on this host, logged;
    over NCCL the process takes card :func:`.collectives.local_card`
    (``LOCAL_RANK``, else the process id); ``device="cpu"`` for processes
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
        torch.cuda.set_device(local_card(process_id))
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


def launcher_settings() -> Optional[Tuple[str, int, int]]:
    """The process group a launcher asks this process to join, as
    :func:`initialize_multihost`'s ``(coordinator_address, num_processes,
    process_id)``, or None when the process runs alone.  JAX's
    ``DDPS_COORDINATOR`` / ``DDPS_NUM_PROCESSES`` / ``DDPS_PROCESS_ID``
    where ``DDPS_NUM_PROCESSES`` is set, else torchrun's
    ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``; a count of one
    process is None too."""
    env = os.environ
    if "DDPS_NUM_PROCESSES" in env:
        names = ("DDPS_COORDINATOR", "DDPS_NUM_PROCESSES", "DDPS_PROCESS_ID")
    elif "WORLD_SIZE" in env:
        names = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
    else:
        return None
    world = int(env[names[-2]])
    if world <= 1:
        return None
    missing = [k for k in names if k not in env]
    if missing:
        raise ValueError(f"{names[-2]}={world} without {', '.join(missing)}")
    address = ":".join(env[k] for k in names[:-2])
    return address, world, int(env[names[-1]])


def launch_refusal(nparts: int) -> Optional[str]:
    """Why a driver of ``nparts`` parts cannot run in the launcher's group
    (:func:`launcher_settings`): a count its processes do not divide, as
    JAX's ``_local_rows`` refuses; None when it can.  Every process finds
    the same answer without a collective."""
    settings = launcher_settings()
    if settings is None or nparts % settings[1] == 0:
        return None
    return (f"{nparts} is not a multiple of the {settings[1]} processes: "
            "each process holds parts / processes parts")


@contextlib.contextmanager
def launched(cpu: bool = False) -> Iterator[torch.device]:
    """A driver's run, alone or in the group a launcher asks for
    (:func:`launcher_settings`); yields the device it computes on.

    Alone: the CPU with ``cpu``, else the card (``resolve_device(None)``,
    which raises without one).  In a group of several processes: the CPU
    with ``cpu``, else this process's card :func:`.collectives.local_card`;
    the process joins the group (:func:`initialize_multihost`: gloo on the
    CPU and on a shared card, NCCL with a card per process) unless it is
    in one already, and leaves it at the end if it joined.  Only process 0
    prints: the others' standard output is discarded for the run (their
    errors are not)."""
    from ..utils.device import resolve_device

    settings = launcher_settings()
    if settings is None:
        yield resolve_device("cpu" if cpu else None)
        return
    address, world, rank = settings
    if cpu:
        device = torch.device("cpu")
    else:
        resolve_device(None)  # raises without a card
        device = torch.device("cuda", local_card(rank))
        torch.cuda.set_device(device)  # the kernels launch on this card
    joined = not dist.is_initialized()
    if joined:
        initialize_multihost(address, world, rank, device=str(device))
    try:
        with contextlib.ExitStack() as stack:
            if dist.get_rank():
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            yield device
    finally:
        if joined:
            dist.destroy_process_group()


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
