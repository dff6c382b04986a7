"""The deployments the benchmark drives, one module per kind of system.

A configuration file names its module under ``"system"``.  Each module has
``setup(config, traffic, device, spans) -> Session``; a session answers
one request at a time and keeps its warm start between requests:

- ``prepare(temps)``: the client's own work for the next request, outside
  its timed span (a right-hand side the program cannot form itself);
- ``request(temps) -> Answer``: the timed call into the program, from the
  request handed over to the answer as a host array;
- ``fine_operators()``: ``(kind, kernel, operator)`` of the fine
  operator, whose products a traced run marks so that its kernel's
  launches are told apart from the levels' (``kind`` names the metric
  family, ``kernel`` a substring of the kernel's name in the trace);
- ``close()``: drops every reference to the program's state.

Temperatures are a dict from nodeset id to value.

A cell on several cards runs one process per card (``portbench/group.py``),
each a rank of the program's group (``torch.distributed``, joined before
``setup``).  ``setup`` runs on every rank, on that rank's device.
``prepare`` and ``request`` are called in step on every rank, with the
same temperatures; a request may run the program's collectives.  The
answer's ``x`` is the whole host answer on rank 0 and may be None on the
others; ``iterations`` and ``converged`` hold on every rank.
``fine_operators`` and ``close`` run on every rank; ``reference_mesh``,
and the judging of the answers, on rank 0 alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Answer"]


@dataclasses.dataclass
class Answer:
    x: Optional[np.ndarray]  # the answer on the free nodes, host array
    iterations: int  # CG iterations (summed over sweeps for refinement)
    converged: bool
    # Milliseconds of the request spent in the solver's iterations, where
    # the session can tell (spans in traced runs, the refinement's own
    # timings); None elsewhere.
    solve_ms: Optional[float] = None
    copy_ms: Optional[float] = None  # refinement: staging + fetch
