"""Whole-solver fusion: Jacobi-preconditioned CG in ONE kernel launch.

Counterpart of the JAX package's ``solvers/fused_cg.py``, which runs the
whole Krylov loop (matvec, dots, axpys, the convergence test) inside one
``pallas_call`` on a VMEM-resident operator, so that a solve costs one
dispatch.  On a CUDA tensor :func:`fused_cg_solve` launches
``csrc/fused_cg.cu`` once and reads the stats buffer once; if the launch
fails it raises (there is no fallback to :func:`.cg.cg_solve`).  The kernel
has two instances, chosen once per operator by :func:`fused_cg_instance`:

- the **cluster** instance for operators that fit on chip (at most 16,384
  rows, every CTA's slots and window within a block's shared memory): a
  thread-block cluster of ``n_pad / 1024`` CTAs of 1024 rows, the operator
  resident in shared memory, p exchanged through distributed shared
  memory; the host packer :func:`cluster_pack` gives every CTA a window
  of p covering its columns and 16-bit columns into it;
- the **grid** instance for any other: a persistent cooperative kernel
  that keeps every block resident and meets at grid-wide barriers.

On a CPU tensor it runs :func:`fused_cg_plain`, the same recurrence and
stopping test in plain PyTorch on :func:`..ops.bsg.spmv_plain`;
:func:`cluster_spmv_plain` is the cluster instance's product (window
gather, local columns) in plain PyTorch, which the tests hold against
``spmv_plain``.

The contract is JAX's (``fused_cg.py:148-194`` there): a dense-layout
operator with int8, bfloat16 or float32 values (each converted to float32
before its product, as the TPU kernel converts them, ``fused_cg.py:50``
there), float32 vectors in its internal padded space,
``invd = where(d != 0, 1/d, 0)`` (not the Jacobi preconditioner's fill of
1 on zero diagonals), the stopping test on squared norms
``rnorm2 > tol^2 * bnorm2`` with ``bnorm2 = 1`` when ``b = 0``,
``relres = sqrt(rnorm2 / bnorm2)`` and ``converged = rnorm2 <= target2``.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from ..ops._kernels import (
    CLUSTER_CTA_ROWS,
    CLUSTER_MAX_CTAS,
    CLUSTER_MAX_WINDOW,
    CLUSTER_SMEM_BUDGET,
    cluster_smem_bytes,
)
from ..ops.bsg import SLICE, BSGMatrix, spmv_plain
from .cg import CGResult

__all__ = [
    "ClusterPack",
    "FusedPlan",
    "cluster_pack",
    "cluster_spmv_plain",
    "fused_cg_instance",
    "fused_cg_plain",
    "fused_cg_plan",
    "fused_cg_solve",
]

# The value storages of the fused kernel: JAX's (its vectors are float32).
_STORAGES = ("int8", "bfloat16", "float32")


def fused_cg_instance(n_pad: int, max_slots: int, max_win: int) -> str:
    """``"cluster"`` when an operator of ``n_pad`` rows fits the cluster
    instance -- at most 16 CTAs of 1024 rows, the widest window within
    16-bit local columns, the largest CTA's slots and window within a
    block's shared memory -- else ``"grid"``.  The shared memory is
    counted with float32 values whatever the operator stores, so narrower
    values never change which instance a size takes."""
    if (n_pad % CLUSTER_CTA_ROWS
            or n_pad > CLUSTER_MAX_CTAS * CLUSTER_CTA_ROWS
            or max_win > CLUSTER_MAX_WINDOW
            or cluster_smem_bytes(max_slots, max_win) > CLUSTER_SMEM_BUDGET):
        return "grid"
    return "cluster"


@dataclasses.dataclass(frozen=True)
class ClusterPack:
    """The cluster instance's view of a dense sliced-ELL operator: CTA
    ``k`` owns rows ``[1024 k, 1024 (k + 1))``, i.e. slices ``32 k ..
    32 k + 31`` and their contiguous slots.  Its window is the columns
    ``windows[2k] .. windows[2k] + windows[2k + 1] - 1``, the span of the
    columns of its nonzero slots widened to start and end on multiples of
    4 (the kernel exchanges four rows in one 16-byte store); ``lcols``
    holds every slot's column minus its CTA's ``lo`` as uint16 bits in an
    int16 tensor (0 for slots of value 0, whose product is 0 whatever they
    read)."""

    ctas: int
    lcols: torch.Tensor  # (n_slots,) int16: uint16 window columns
    windows: torch.Tensor  # (2 * ctas,) int32: lo, width per CTA
    max_slots: int  # slots of the largest CTA (a multiple of 32)
    max_win: int  # the widest window


def cluster_pack(A: BSGMatrix) -> ClusterPack:
    """Pack a dense-layout operator of ``n_pad`` rows (a multiple of 1024)
    for the cluster instance, on the host; the tensors land on ``A``'s
    device.  A window wider than 2^16 columns keeps its width (the
    instance rule then refuses the operator) and its columns wrap."""
    if A.chunk or A.n_pad % CLUSTER_CTA_ROWS:
        raise ValueError("the cluster pack takes a dense-layout operator of "
                         "a multiple of 1024 rows")
    ctas = A.n_pad // CLUSTER_CTA_ROWS
    per_cta = CLUSTER_CTA_ROWS // SLICE
    sp = A.slice_ptr.cpu().numpy()
    cols = A.cols.cpu().numpy().astype(np.int64)
    nz = (A.vals != 0).cpu().numpy()
    bounds = sp[np.arange(ctas + 1) * per_cta]
    lcols = np.zeros(cols.size, dtype=np.int64)
    windows = np.zeros((ctas, 2), dtype=np.int64)
    for k in range(ctas):
        s0, s1 = int(bounds[k]), int(bounds[k + 1])
        used = nz[s0:s1]
        c = cols[s0:s1]
        lo, hi = (int(c[used].min()), int(c[used].max())) if used.any() \
            else (0, 0)
        lo, hi = lo // 4 * 4, hi // 4 * 4 + 3  # n_pad is a multiple of 4
        windows[k] = lo, hi - lo + 1
        lcols[s0:s1] = np.where(used, c - lo, 0)
    return ClusterPack(
        ctas=ctas,
        lcols=torch.from_numpy(
            (lcols & 0xFFFF).astype(np.uint16).view(np.int16)).to(A.device),
        windows=torch.from_numpy(
            windows.reshape(-1).astype(np.int32)).to(A.device),
        max_slots=int(np.diff(bounds).max()),
        max_win=int(windows[:, 1].max()),
    )


def cluster_spmv_plain(A: BSGMatrix, pack: ClusterPack,
                       x_padded: torch.Tensor) -> torch.Tensor:
    """The cluster instance's product in plain PyTorch: per CTA, gather
    its window of ``x``, multiply its slots by the window at their local
    columns, add them into their rows in slot order (as
    :func:`..ops.bsg.spmv_plain` adds them)."""
    if x_padded.numel() != A.n_pad:
        raise ValueError(f"x must have the operator's {A.n_pad} rows")
    per_cta = CLUSTER_CTA_ROWS // SLICE
    bounds = A.slice_ptr[torch.arange(pack.ctas + 1, device=A.device)
                         * per_cta].tolist()
    wins = pack.windows.view(-1, 2).tolist()
    key = A.slot_key()
    lcols = pack.lcols.to(torch.int64) & 0xFFFF
    y = x_padded.new_zeros(pack.ctas * CLUSTER_CTA_ROWS)
    for k, (lo, width) in enumerate(wins):
        s0, s1 = bounds[k], bounds[k + 1]
        window = x_padded[lo:lo + width]
        prod = A.vals[s0:s1].to(x_padded.dtype) * window[lcols[s0:s1]]
        y.index_add_(0, key[s0:s1], prod)
    return y[: A.n_pad]


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """What :func:`fused_cg_solve` needs of an operator, built once:
    ``invd`` (JAX's inverse diagonal), the instance, and the cluster pack
    when the instance is ``"cluster"``."""

    invd: torch.Tensor
    instance: str
    pack: Optional[ClusterPack]


# id(operator) -> its plan (a BSGMatrix is an unhashable dataclass, so no
# WeakKeyDictionary); an entry goes with its operator.
_PLANS: Dict[int, FusedPlan] = {}


def fused_cg_plan(A: BSGMatrix) -> FusedPlan:
    """The operator's :class:`FusedPlan`, built once per operator: the
    cluster instance when :func:`fused_cg_instance` admits its pack, else
    the grid instance (operators of more than 16,384 rows, or of rows
    padded to other than a multiple of 1024, are not packed)."""
    plan = _PLANS.get(id(A))
    if plan is None:
        pack = None
        if (A.n_pad <= CLUSTER_MAX_CTAS * CLUSTER_CTA_ROWS
                and A.n_pad % CLUSTER_CTA_ROWS == 0):
            pack = cluster_pack(A)
            if fused_cg_instance(A.n_pad, pack.max_slots,
                                 pack.max_win) != "cluster":
                pack = None
        plan = FusedPlan(invd=_inverse_diagonal(A),
                         instance="cluster" if pack else "grid", pack=pack)
        _PLANS[id(A)] = plan
        weakref.finalize(A, _PLANS.pop, id(A), None)
    return plan


def _inverse_diagonal(A: BSGMatrix) -> torch.Tensor:
    d = A.diag
    return torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 0.0)


def fused_cg_plain(A: BSGMatrix, b: torch.Tensor, x0: torch.Tensor,
                   invd: torch.Tensor, *, tol: float,
                   maxiter: int) -> CGResult:
    """The fused kernel's recurrence in plain PyTorch: Jacobi-PCG with the
    squared-norm stopping test, float32 throughout."""
    target_scale = torch.tensor(np.float32(tol * tol))
    x = x0.clone()
    r = b - spmv_plain(A, x)
    z = invd * r
    p = z
    b2 = torch.dot(b, b)
    bnorm2 = torch.where(b2 == 0, torch.ones_like(b2), b2)
    target2 = target_scale.to(b.device) * bnorm2
    rz = torch.dot(r, z)
    rnorm2 = torch.dot(r, r)
    k = 0
    while k < maxiter and bool(rnorm2 > target2):
        ap = spmv_plain(A, p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = invd * r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rnorm2 = torch.dot(r, r)
        k += 1
    return CGResult(
        x=x,
        iterations=k,
        relres=float(torch.sqrt(rnorm2 / bnorm2)),
        converged=bool(rnorm2 <= target2),
    )


def fused_cg_solve(
    A: BSGMatrix,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-6,
    maxiter: int = 300,
) -> CGResult:
    """Solve ``A x = b`` (both in the operator's padded space) with
    Jacobi-preconditioned CG, the whole solve in one kernel launch on the
    card.  Same contract as :func:`.cg.cg_solve` with ``precond=jacobi``;
    vectors are float32, the operator's values int8, bfloat16 or
    float32."""
    if A.chunk:
        raise ValueError(
            "fused_cg_solve requires the dense sliced-ELL layout (the kernel "
            "walks each slice with one thread per row); pack with "
            "bsg_from_csr(..., layout='dense')"
        )
    if A.storage not in _STORAGES or A.x_len != A.n_pad:
        raise ValueError("fused_cg_solve takes a square operator stored as "
                         "int8, bfloat16 or float32")
    b = b.to(torch.float32).contiguous()
    if x0 is not None:
        x0 = x0.to(torch.float32).contiguous()
    if b.numel() != A.n_pad or (x0 is not None and x0.numel() != A.n_pad):
        raise ValueError(f"vectors must have the operator's {A.n_pad} rows")
    if b.device.type == "cpu":
        x0 = torch.zeros_like(b) if x0 is None else x0
        return fused_cg_plain(A, b, x0, _inverse_diagonal(A), tol=tol,
                              maxiter=maxiter)
    from ..ops._kernels import fused_cg_cluster_launch, fused_cg_launch

    plan = fused_cg_plan(A)
    if plan.instance == "cluster":
        pk = plan.pack
        x, stats, _active = fused_cg_cluster_launch(
            A.vals, pk.lcols, A.slice_ptr, pk.windows, pk.max_slots,
            pk.max_win, b, plan.invd, x0, tol, maxiter)
    else:
        x0 = torch.zeros_like(b) if x0 is None else x0
        x, stats = fused_cg_launch(A.slice_ptr, A.cols, A.vals, b,
                                   plan.invd, x0, tol, maxiter)
    k, relres, converged, _rnorm2 = stats.tolist()
    return CGResult(x=x, iterations=int(k), relres=float(relres),
                    converged=converged > 0)
