"""Transient heat equation: implicit time stepping on the graph Laplacian.

Counterpart of the JAX package's ``models/transient.py``.  The reference
solves only the steady state; its Exodus "timesteps" are solver-iteration
snapshots (``BelosMueLuSolver.cpp:112-133``).  This model family adds the
dynamics

    du/dt = -(A u - b),   u(0) = u0

with unconditionally stable implicit Euler: each step solves

    (I + dt A) u_{n+1} = u_n + dt b

by CG with the Jacobi preconditioner, warm-started from the previous step.
The steady state of the flow is the reference's solution of ``A u = b``.

Vectors live in the operator's own space: ``put_vector``/``get_vector`` and
its pad mask, so a permuted operator (sliced ELL with ``perm``) gives the
same answer as an identity-layout one.  JAX pads in the original order
(``pad_vector``), which is right only for identity-layout operators.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..solvers.cg import cg_solve_with_state
from ..solvers.precond.jacobi import DiagonalPreconditioner
from .heat import HeatSystem

__all__ = ["TransientResult", "transient_heat_solve", "ShiftedOperator"]


@dataclasses.dataclass
class TransientResult:
    times: np.ndarray  # (n_steps,)
    u: np.ndarray  # (n_free,) final state
    history: Optional[np.ndarray]  # (n_steps, n_free) if recorded
    total_cg_iterations: int


@dataclasses.dataclass
class ShiftedOperator:
    """``(I + dt A)`` over any operator of the port (``matvec``,
    ``diagonal_padded``, ``put_vector`` and ``n_rows``)."""

    A: Any
    dt: float

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.dt * self.A.matvec(x)

    def diagonal_padded(self, fill: float = 1.0) -> torch.Tensor:
        d = 1.0 + self.dt * self.A.diagonal_padded(fill=0.0)
        # The slots no row maps to, in the operator's own layout.
        real = self.A.put_vector(np.ones(self.A.n_rows), dtype=d.dtype)
        return d.masked_fill(real == 0, fill)


def transient_heat_solve(
    system: HeatSystem,
    operator,
    *,
    dt: float = 0.01,
    n_steps: int = 50,
    u0: Optional[np.ndarray] = None,
    tol: float = 1e-10,
    maxiter: int = 500,
    record: bool = False,
    callback: Optional[Callable[[int, float, np.ndarray], None]] = None,
    dtype=None,
) -> TransientResult:
    """Integrate du/dt = -(A u - b) with implicit Euler and warm-started CG.

    ``operator`` is the device operator for A (from
    :func:`..ops.dia.choose_operator`); the shifted systems reuse it
    unchanged, on its device.  ``callback(step, t, u_host)`` fires after
    every step (the hook a solution writer uses for one Exodus timestep per
    step); the state is fetched to the host only when ``record`` or
    ``callback`` asks for it.  ``dtype`` is accepted and not read, as in
    JAX: the operator's dtype is the working dtype."""
    n = system.n_free
    dtype = operator.dtype
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    shifted = ShiftedOperator(A=operator, dt=dt)
    M = DiagonalPreconditioner(1.0 / shifted.diagonal_padded())
    b = operator.put_vector(np.asarray(system.b, dtype=np_dtype), dtype=dtype)
    u = operator.put_vector(
        np.zeros(n, dtype=np_dtype) if u0 is None
        else np.asarray(u0, dtype=np_dtype),
        dtype=dtype,
    )
    dt_t = torch.tensor(dt, dtype=dtype, device=b.device)
    times = []
    hist: List[np.ndarray] = []
    total_iters = 0
    t = 0.0
    for step in range(1, n_steps + 1):
        rhs = u + dt_t * b
        res, _ = cg_solve_with_state(shifted, rhs, u, precond=M, tol=tol,
                                     maxiter=maxiter)
        u = res.x
        total_iters += res.iterations
        t += dt
        times.append(t)
        if record or callback is not None:
            u_host = operator.get_vector(u)
            if record:
                hist.append(np.array(u_host))
            if callback is not None:
                callback(step, t, u_host)
    return TransientResult(
        times=np.asarray(times),
        u=operator.get_vector(u),
        history=np.stack(hist) if hist else None,
        total_cg_iterations=total_iters,
    )
