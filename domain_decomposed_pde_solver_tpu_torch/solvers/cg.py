"""Preconditioned conjugate gradient on PyTorch tensors.

Counterpart of the JAX package's ``solvers/cg.py``: the same recurrence,
stopping rule (``||r|| <= tol * ||b||``, compared in the vectors' dtype) and
result record.  JAX runs the loop as one ``lax.while_loop`` program; here it
is a Python loop that reads one boolean from the device per iteration (the
stopping test).  Capturing the loop in a CUDA graph is later work.
:func:`cg_solve_with_state` is a span ``cg`` of the recorder
(``utils/timers.py``); each pass of its loop is a span ``cg.iter``, whose
stopping test's read is a span ``cg.sync`` (the test before the first pass
is one directly under ``cg``).

Operators are objects with ``.matvec(x)``; preconditioners are callables.
The dot product is injectable (``dot=``, default :func:`torch.dot`), as in
JAX: the sharded solvers (``parallel/sharded.py``) pass one that takes
``(P, n_local)`` vectors and adds the parts' dots in part order, so the
same loop runs over a partitioned vector.
:func:`cg_solve_resumable` checkpoints the recurrence to a file every few
iterations and continues from it (``utils/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from ..utils.timers import host_value, span, to_device

__all__ = [
    "CGResult",
    "IdentityPrecond",
    "cg_solve",
    "cg_solve_resumable",
    "cg_solve_snapshots",
    "cg_solve_with_state",
]


class IdentityPrecond:
    """No-op preconditioner."""

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return r


@dataclasses.dataclass
class CGResult:
    x: torch.Tensor
    iterations: int
    relres: float  # achieved ||r|| / ||b||
    converged: bool


def cg_solve(
    A: Any,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    precond: Any = None,
    tol: float = 1e-14,
    maxiter: int = 300,
    dot: Callable = torch.dot,
) -> CGResult:
    """Solve ``A x = b`` with (preconditioned) CG; ``tol`` is relative to
    ``||b||``."""
    result, _ = cg_solve_with_state(
        A, b, x0, precond=precond, tol=tol, maxiter=maxiter, dot=dot
    )
    return result


def cg_solve_with_state(
    A: Any,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    state: Any = None,
    precond: Any = None,
    tol: float = 1e-14,
    maxiter: int = 300,
    dot: Callable = torch.dot,
):
    """Like :func:`cg_solve` but returns ``(result, (r, p, rz))`` and can
    resume from a prior state exactly."""
    with span("cg"):
        M = precond if precond is not None else IdentityPrecond()
        bnorm = torch.sqrt(dot(b, b))
        bnorm = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
        target = to_device(torch.tensor(tol, dtype=b.dtype), b.device) * bnorm

        if state is None:
            r = b - A.matvec(x0)
            z = M(r)
            p = z
            rz = dot(r, z)
        else:
            r, p, rz = state
        x = x0
        rnorm = torch.sqrt(dot(r, r))
        k = 0
        go = k < maxiter and _more(rnorm, target)
        while go:
            # One pass: the step and the stopping test that decides the next.
            with span("cg.iter"):
                x, r, p, rz, rnorm = _cg_step(A, M, x, r, p, rz, dot)
                k += 1
                go = k < maxiter and _more(rnorm, target)
        result = CGResult(
            x=x,
            iterations=k,
            relres=host_value(rnorm / bnorm),
            converged=host_value(rnorm <= target),
        )
    return result, (r, p, rz)


def _more(rnorm: torch.Tensor, target: torch.Tensor) -> bool:
    """The stopping test's device read, a span ``cg.sync``: True while the
    residual norm is above the target."""
    more = rnorm > target
    with span("cg.sync"):
        return host_value(more)


def cg_solve_snapshots(
    A: Any,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    precond: Any = None,
    tol: float = 1e-14,
    maxiter: int = 300,
    dot: Callable = torch.dot,
    callback: Optional[Callable[[int, torch.Tensor, float], None]] = None,
) -> CGResult:
    """CG with a host callback after every iteration, ``callback(k, x,
    relres)``: the reference's per-iteration solution snapshots
    (``BelosMueLuSolver.cpp:112-133``) on one continuous Krylov
    recurrence.  The stopping test is JAX's: ``||r|| / ||b|| > tol`` on
    host floats.  ``dot`` as in :func:`cg_solve`."""
    M = precond if precond is not None else IdentityPrecond()
    bnorm = float(torch.sqrt(dot(b, b)))
    bnorm = bnorm if bnorm != 0 else 1.0
    r = b - A.matvec(x0)
    z = M(r)
    p = z
    rz = dot(r, z)
    x = x0
    rnorm = float(torch.sqrt(dot(r, r)))
    k = 0
    while rnorm / bnorm > tol and k < maxiter:
        x, r, p, rz, rn = _cg_step(A, M, x, r, p, rz, dot)
        rnorm = float(rn)
        k += 1
        if callback is not None:
            callback(k, x, rnorm / bnorm)
    return CGResult(
        x=x,
        iterations=k,
        relres=rnorm / bnorm,
        converged=rnorm / bnorm <= tol,
    )


def _cg_step(A, M, x, r, p, rz, dot=torch.dot):
    """One CG iteration: the body of :func:`cg_solve_with_state`'s loop,
    also returning the new residual norm (a device scalar)."""
    Ap = A.matvec(p)
    alpha = rz / dot(p, Ap)
    x = x + alpha * p
    r = r - alpha * Ap
    z = M(r)
    rz_new = dot(r, z)
    p = z + rz_new / rz * p
    return x, r, p, rz_new, torch.sqrt(dot(r, r))


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host array; bfloat16, which numpy lacks, as
    its raw 16-bit words."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def operator_arrays(A: Any) -> Iterator[np.ndarray]:
    """The arrays that fingerprint an operator, in a fixed order: the fields
    of its dataclass in declaration order, skipping ``_``-prefixed caches;
    a tensor gives its values and a tuple of integers (DIA's offsets) an
    int64 array."""
    if not dataclasses.is_dataclass(A):
        raise TypeError(f"cannot fingerprint a {type(A).__name__}")
    for f in dataclasses.fields(A):
        if f.name.startswith("_"):
            continue
        v = getattr(A, f.name)
        if isinstance(v, torch.Tensor):
            yield _host_array(v)
        elif isinstance(v, tuple) and all(isinstance(e, int) for e in v):
            yield np.asarray(v, dtype=np.int64)


def _blake(arrays) -> str:
    """JAX's problem hash: shape and dtype, then the bytes, of each array."""
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        a = np.asarray(a)
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def cg_solve_resumable(
    A: Any,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    precond: Any = None,
    tol: float = 1e-14,
    maxiter: int = 300,
    dot: Callable = torch.dot,
) -> CGResult:
    """CG with a checkpoint every ``checkpoint_every`` iterations and exact
    resume: the counterpart of the JAX package's ``cg_solve_resumable``,
    with its file format, stopping test (``||r|| / ||b|| > tol`` on host
    floats) and refusal of another problem's checkpoint.

    If ``checkpoint_path`` holds a state of the same problem, the recurrence
    continues from it; ``(x, r, p, rz, k)`` determines the remaining
    iterations, and ``rz`` goes through the file as a Python float, which is
    exact for float32 and float64, so on one device a resumed run is
    bit-identical to an unbroken one.  The problem's fingerprint hashes
    ``b`` as JAX does and the operator's arrays in the order of
    :func:`operator_arrays`; JAX hashes its operator's pytree leaves, so a
    checkpoint written by the JAX package carries another operator hash and
    is refused here with JAX's ``ValueError``.  ``dot`` as in
    :func:`cg_solve`; it does not enter the fingerprint.
    """
    from ..utils.checkpoint import CGCheckpoint, load_checkpoint, save_checkpoint

    M = precond if precond is not None else IdentityPrecond()
    bnorm = float(torch.sqrt(dot(b, b))) or 1.0
    b_hash = _blake([_host_array(b)])
    a_hash = _blake(operator_arrays(A))

    ck = load_checkpoint(checkpoint_path)
    if ck is not None and (
        ck.meta.get("b_hash") not in (None, b_hash)
        or ck.meta.get("a_hash") not in (None, a_hash)
    ):
        raise ValueError(
            f"checkpoint {checkpoint_path!r} belongs to a different problem "
            f"(RHS hash {ck.meta.get('b_hash')} vs {b_hash}, operator hash "
            f"{ck.meta.get('a_hash')} vs {a_hash}); delete it or use a "
            "different --checkpoint path"
        )
    if ck is not None and ck.x.shape == tuple(x0.shape):
        def put(a):
            return torch.from_numpy(np.asarray(a)).to(dtype=b.dtype,
                                                       device=b.device)

        x, r, p = put(ck.x), put(ck.r), put(ck.p)
        rz = torch.tensor(ck.rz, dtype=b.dtype, device=b.device)
        k = ck.iteration
    else:
        x = x0
        r = b - A.matvec(x0)
        p = M(r)
        rz = dot(r, p)
        k = 0
    rnorm = float(torch.sqrt(dot(r, r)))
    while rnorm / bnorm > tol and k < maxiter:
        x, r, p, rz, rn = _cg_step(A, M, x, r, p, rz, dot)
        rnorm = float(rn)
        k += 1
        if k % checkpoint_every == 0:
            save_checkpoint(
                checkpoint_path,
                CGCheckpoint(
                    x=_host_array(x), r=_host_array(r), p=_host_array(p),
                    rz=float(rz), iteration=k,
                    meta={"bnorm": bnorm, "tol": tol, "b_hash": b_hash,
                          "a_hash": a_hash},
                ),
            )
    return CGResult(
        x=x,
        iterations=k,
        relres=rnorm / bnorm,
        converged=rnorm / bnorm <= tol,
    )
