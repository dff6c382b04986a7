"""Partitioned mixed-precision refinement on the slab pad-stencil engine.

Counterpart of the JAX package's ``parallel/slabpadmixed.py``: the f32
slab CG+AMG solve (:mod:`.slabpadamg`) is the inner solver of an f64
refinement loop over the same slabs:

    sweep:  r32  = (r64 / ||r64||) cast                  [f32]
            e32  = CG+AMG solve of A e = r32             [f32, kernel 3
                                                          per slab]
            x64 += ||r64|| * e64                         [f64]
            r64  = b64 - A x64                           [f64, kernel 3's
                                                          double instance
                                                          per slab]

The f64 residual is the slab operator's own product in double: on the
card the pad-stencil kernel's f64 instance on every part's window, as the
single-device refinement runs it (``solvers/mixed.py``); on the CPU its
plain version on the same window, which is JAX's masked ``stencil_core``
evaluation (``slabpadmixed.py:71-86`` there): the same taps, and 0 on the
dead layers.  The graph Laplacian's f32-stored coefficients are integers,
so the f64 residual is exact to f64 rounding.  JAX refuses to run without
``jax_enable_x64``; the port always has f64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..solvers.cg import cg_solve
from ..solvers.mixed import MixedSolveResult, _adaptive_inner_tol, _sync
from ..utils.timers import host_value, span, spanned
from .sharded import DeviceMesh
from .slab import plan_mesh
from .slabpadamg import SlabPadAMG

__all__ = ["slab_pad_amg_refine_solve"]


@spanned("refine")
def slab_pad_amg_refine_solve(
    samg: SlabPadAMG,
    pad_op=None,
    b: Optional[np.ndarray] = None,
    x0: Optional[np.ndarray] = None,
    *,
    mesh: Optional[DeviceMesh] = None,
    tol: float = 1e-10,
    inner_tol: float = 1e-6,
    inner_maxiter: int = 200,
    max_refinements: int = 20,
) -> MixedSolveResult:
    """An f64-accurate solve over the slabs: f32 CG+AMG sweeps inside an
    f64 refinement loop with one host read per sweep.

    ``pad_op``: the global operator the hierarchy was built on (default
    ``samg.pad_op``; only checked for presence, as the slab operator
    carries its stencil).  ``x0``: an optional f64 warm start (one more
    residual product); the default zero start knows ``r0 = b``.  Each
    process stages only its parts' real rows of ``b`` and ``x0``, and
    ``||b||`` is the loop's own dot of the staged ``b`` on the device.
    The result's ``x`` is the host f64 answer in the logical
    (lexicographic) order, a new array: over a hierarchy built on a mesh
    of several processes, each process runs its parts, the processes
    gather the parts' real rows on their devices, and each process
    fetches the whole answer through a page-locked buffer
    (:meth:`.slabpad.SlabPadPlan.gather_vector`)."""
    if pad_op is None:
        pad_op = samg.pad_op
    if pad_op is None:
        raise ValueError("pad_op missing (the hierarchy has no pad_op)")
    if b is None:
        raise ValueError("b is required")
    plan = samg.plan
    dot = plan_mesh(plan, mesh).dot
    dev = plan.device

    with span("refine.stage") as stage:
        op = samg.A
        b64 = plan.put_vector(b, dtype=np.float64)
        bnorm = host_value(torch.sqrt(dot(b64, b64))) or 1.0
        if x0 is None:
            x64 = torch.zeros_like(b64)
            r64 = b64  # r0 = b exactly, no product
            relres = 1.0
        else:
            x64 = plan.put_vector(x0, dtype=np.float64)
            r64 = b64 - op.matvec(x64)
            relres = host_value(torch.sqrt(dot(r64, r64))) / bnorm
        _sync(dev)

    with span("refine.sweeps") as sweeps:
        inner_total = 0
        refinements = 0
        while relres > tol and refinements < max_refinements:
            itol = _adaptive_inner_tol(inner_tol, tol, relres)
            rnorm = torch.sqrt(dot(r64, r64))
            rnorm = torch.where(rnorm == 0, torch.ones_like(rnorm), rnorm)
            r32 = (r64 / rnorm).to(torch.float32)
            res = cg_solve(op, r32, torch.zeros_like(r32), precond=samg,
                           tol=itol, maxiter=inner_maxiter, dot=dot)
            x_new = x64 + res.x.to(torch.float64) * rnorm
            r_new = b64 - op.matvec(x_new)
            new_relres = host_value(torch.sqrt(dot(r_new, r_new))) / bnorm
            inner_total += int(res.iterations)
            refinements += 1
            if new_relres >= relres:  # stagnation at the f32 floor
                break
            x64, r64, relres = x_new, r_new, new_relres
    with span("refine.fetch") as fetch:
        x_host = plan.gather_vector(x64)
    return MixedSolveResult(
        x=x_host,
        refinements=refinements,
        inner_iterations=inner_total,
        relres=relres,
        converged=relres <= tol,
        timings={
            "stage_ms": stage.ms,
            "sweeps_ms": sweeps.ms,
            "fetch_ms": fetch.ms,
        },
    )
