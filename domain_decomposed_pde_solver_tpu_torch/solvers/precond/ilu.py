"""ILU(0) and ILUT preconditioners — the reference-parity incomplete
factorizations, counterpart of the JAX package's ``solvers/precond/ilu.py``.

The reference's production configuration is Belos GMRES right-preconditioned
with Ifpack2 ILUT (``BelosMueLuSolver.cpp:92-106``, default parameters).
The factorization is sequential and runs on the host, as Ifpack2's does:
the port's native copies (``utils/native.py``: ``ilu0_native``,
``ilut_native``, ``tri_levels_native``), with JAX's NumPy fallbacks where
the native library is absent.

The apply is two level-scheduled triangular sweeps on the device in plain
PyTorch (JAX computes them outside Pallas too, ``_tri_sweep``): the rows of
each factor are grouped into dependency levels, a level's rows are
independent of each other, and each level is one gather, multiply, row sum
and scatter.  JAX slices a static window of the largest level's size (a
static shape for XLA); the port slices every level exactly.  The sweep
costs a handful of launches per level, so it is launch-bound by design: it
exists for answer and iteration parity with the reference's solver stack,
not as the fast path (AMG is).

One difference from JAX: its packer stores the factor values and the
inverse diagonal in float32 and casts them to the solve's dtype
(``ilu.py:115, :356`` there); the port keeps them in the solve's dtype.
:func:`ilu_from_arrays` (also ``utils.convert.ilu_from_numpy``) adopts
JAX's packed arrays as they are, for tests that hold both applies to the
same factors.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops.csr import CSRMatrix
from ...ops.ell import pad_to
from ...utils.device import resolve_device

__all__ = [
    "ILU0Preconditioner",
    "ilu_from_arrays",
    "ilu0_factor",
    "ilu0_preconditioner",
    "ilut_preconditioner",
]


def ilu0_factor(csr: CSRMatrix) -> Tuple[np.ndarray, np.ndarray]:
    """ILU(0) of a column-sorted CSR: returns ``(lu_data, diag_pos)``.

    ``lu_data`` holds L (strictly lower, unit diagonal implied) and U
    (upper including the diagonal) in A's sparsity pattern, like Ifpack2's
    ``compute()``.  Native C++ when available, NumPy otherwise.  Raises
    ``ZeroDivisionError`` on a zero pivot."""
    from ...utils.native import ilu0_native

    n = csr.n_rows
    out = ilu0_native(csr.indptr, csr.indices, csr.data, n)
    if out is not None:
        return out

    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    lu = np.asarray(csr.data, dtype=np.float64).copy()
    diag_pos = np.full(n, -1, dtype=np.int64)
    pos = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        row_cols = indices[s:e]
        pos[row_cols] = np.arange(s, e)
        dp = pos[i]
        if dp < 0:
            raise ZeroDivisionError(f"ILU(0): missing diagonal at row {i}")
        diag_pos[i] = dp
        for p in range(s, e):
            k = indices[p]
            if k >= i:
                break
            pivot = lu[diag_pos[k]]
            if pivot == 0.0:
                raise ZeroDivisionError(f"ILU(0): zero pivot at row {k}")
            lik = lu[p] / pivot
            lu[p] = lik
            ks, ke = diag_pos[k] + 1, indptr[k + 1]
            pp = pos[indices[ks:ke]]
            hit = pp >= 0
            lu[pp[hit]] -= lik * lu[ks:ke][hit]
        if lu[dp] == 0.0:
            raise ZeroDivisionError(f"ILU(0): zero pivot at row {i}")
        pos[row_cols] = -1
    return lu, diag_pos


def _tri_levels(indptr, indices, n, lower: bool) -> Tuple[np.ndarray, int]:
    """Dependency level of every row of a triangular factor, and the count."""
    from ...utils.native import tri_levels_native

    out = tri_levels_native(indptr, indices, n, lower)
    if out is not None:
        return out
    level = np.zeros(n, dtype=np.int64)
    nlev = 0
    rng = range(n) if lower else range(n - 1, -1, -1)
    for i in rng:
        deps = indices[indptr[i]: indptr[i + 1]]
        deps = deps[deps < i] if lower else deps[deps > i]
        lv = int(level[deps].max()) + 1 if deps.size else 0
        level[i] = lv
        nlev = max(nlev, lv + 1)
    return level, nlev


def _pack_tri_levels(rows_sorted, level_of, nlev, indptr, indices, vals):
    """A triangular factor as solve-ordered ELL: ``(cols (R, K) int64,
    vals (R, K) float64, rows (R,) int64, starts, counts)`` with R the rows
    in solve order and the level windows as host int arrays."""
    lens = np.diff(indptr)[rows_sorted]
    K = max(int(lens.max()) if lens.size else 1, 1)
    R = rows_sorted.size
    cols = np.zeros((R, K), dtype=np.int64)
    v = np.zeros((R, K), dtype=np.float64)
    total = int(lens.sum())
    out_rows = np.repeat(np.arange(R), lens)
    slot = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    src = np.repeat(indptr[rows_sorted], lens) + slot
    cols[out_rows, slot] = indices[src]
    v[out_rows, slot] = vals[src]
    counts = np.bincount(level_of[rows_sorted], minlength=nlev)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    return cols, v, rows_sorted.astype(np.int64), starts, counts


# One level of a sweep: (cols (c, K), vals (c, K), rows (c,), scale (c,)
# or None), views of the factor's solve-ordered arrays.
Level = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def _levels(cols: torch.Tensor, vals: torch.Tensor, rows: torch.Tensor,
            starts: Sequence[int], counts: Sequence[int],
            inv_diag: Optional[torch.Tensor]) -> List[Level]:
    out = []
    for s, c in zip(starts, counts):
        s, e = int(s), int(s) + int(c)
        if e == s:
            continue
        r = rows[s:e]
        out.append((cols[s:e], vals[s:e], r,
                    None if inv_diag is None else inv_diag[r]))
    return out


@dataclasses.dataclass
class ILU0Preconditioner:
    """``M(r) ~= A^{-1} r`` by exact L and U triangular solves of the
    incomplete factors, level-parallel on the device.  ``l_levels`` and
    ``u_levels`` hold, per level in solve order, the level's ELL rows of
    the factor and (U only) the inverse diagonal of its rows."""

    l_levels: List[Level]
    u_levels: List[Level]
    inv_diag: torch.Tensor  # (n_pad,), 1 on padding rows
    n_pad: int

    @property
    def l_nlev(self) -> int:
        return len(self.l_levels)

    @property
    def u_nlev(self) -> int:
        return len(self.u_levels)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        y = _tri_sweep(r, self.l_levels)  # L y = r, unit diagonal
        return _tri_sweep(y, self.u_levels)  # U x = y, diagonal scaled


def _tri_sweep(b: torch.Tensor, levels: Sequence[Level]) -> torch.Tensor:
    """Level-scheduled triangular solve: per level,
    ``x[rows] = (b[rows] - T[rows] x) [* inv_diag[rows]]``; rows outside
    every level (padding) keep ``b``."""
    x = b.clone()
    for cols, vals, rows, scale in levels:
        val = b[rows] - (vals * x[cols]).sum(dim=1)
        if scale is not None:
            val = val * scale
        x[rows] = val
    return x


def ilu0_preconditioner(csr: CSRMatrix, n_pad: Optional[int] = None,
                        dtype=torch.float32,
                        device=None) -> ILU0Preconditioner:
    """Factor ``csr`` with ILU(0) and build the device apply.  ``n_pad``:
    the operator's padded vector length (default ``pad_to(n)``); it must
    match the vectors the solver passes.  ``device`` defaults to the
    card."""
    n = csr.n_rows
    lu, diag_pos = ilu0_factor(csr)
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    rows_all = np.repeat(np.arange(n), np.diff(indptr))

    def _sub(mask):
        cnt = np.bincount(rows_all[mask], minlength=n)
        p = np.concatenate([[0], np.cumsum(cnt)])
        return p.astype(np.int64), indices[mask], lu[mask]

    Lp, Li, Lx = _sub(indices < rows_all)
    Up, Ui, Ux = _sub(indices > rows_all)
    return _build_tri_precond(Lp, Li, Lx, Up, Ui, Ux, lu[diag_pos], n, n_pad,
                              dtype, device)


def ilut_preconditioner(
    csr: CSRMatrix,
    n_pad: Optional[int] = None,
    dtype=torch.float32,
    fill_factor: float = 1.0,
    droptol: float = 0.0,
    device=None,
) -> ILU0Preconditioner:
    """ILUT (Saad's threshold incomplete LU), the literal analogue of the
    reference's preconditioner, Ifpack2 ILUT at its defaults
    (``fact: ilut level-of-fill = 1.0``, ``fact: drop tolerance = 0``,
    ``BelosMueLuSolver.cpp:92-97``).

    ``fill_factor``: each factor row keeps at most
    ``ceil(fill_factor * nnz(A_i))`` entries (largest by magnitude);
    ``droptol``: entries below ``droptol * ||row||_2`` are dropped during
    elimination.  The device apply is the sweep of ILU(0)."""
    Lp, Li, Lx, Up, Ui, Ux, diag = _ilut_factor(csr, fill_factor, droptol)
    return _build_tri_precond(Lp, Li, Lx, Up, Ui, Ux, diag, csr.n_rows,
                              n_pad, dtype, device)


def _ilut_factor(csr: CSRMatrix, fill_factor: float, droptol: float):
    from ...utils.native import ilut_native

    out = ilut_native(
        csr.indptr, csr.indices, csr.data, csr.n_rows, fill_factor, droptol
    )
    if out is not None:
        return out

    # NumPy/Python fallback (row-wise IKJ with a dense working row).
    n = csr.n_rows
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    data = np.asarray(csr.data, dtype=np.float64)
    Lp, Up = [0], [0]
    Li, Lx, Ui, Ux = [], [], [], []
    diag = np.zeros(n)
    Urows = []  # (cols, vals) of every finished U row, for the updates
    w = np.zeros(n)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols_i = indices[s:e]
        w[cols_i] = data[s:e]
        occ = set(cols_i.tolist())
        tau = droptol * np.linalg.norm(data[s:e])
        p_keep = max(1, int(np.ceil(fill_factor * (e - s))))
        # Ascending worklist; lower fill-ins created during elimination are
        # inserted and processed too (always past the current pivot).
        work = sorted(c for c in occ if c < i)
        idx = 0
        while idx < len(work):
            k = work[idx]
            idx += 1
            if w[k] == 0.0:
                continue
            w[k] /= diag[k]
            if abs(w[k]) < tau:
                w[k] = 0.0
                continue
            ucols, uvals = Urows[k]
            for c, v in zip(ucols, uvals):
                if c not in occ:
                    occ.add(c)
                    if c < i:
                        bisect.insort(work, c, lo=idx)
                w[c] -= w[k] * v
        low = sorted(c for c in occ if c < i and w[c] != 0.0)
        upp = sorted(c for c in occ if c > i and w[c] != 0.0)
        lvals = np.array([w[c] for c in low])
        uvals = np.array([w[c] for c in upp])
        keepl = np.sort(np.argsort(-np.abs(lvals), kind="stable")[:p_keep])
        keepu = np.sort(np.argsort(-np.abs(uvals), kind="stable")[:p_keep])
        if w[i] == 0.0:
            raise ZeroDivisionError(f"ILUT: zero pivot at row {i}")
        diag[i] = w[i]
        Li.extend(int(low[j]) for j in keepl)
        Lx.extend(float(lvals[j]) for j in keepl)
        Ui.extend(int(upp[j]) for j in keepu)
        Ux.extend(float(uvals[j]) for j in keepu)
        Lp.append(len(Li))
        Up.append(len(Ui))
        Urows.append(([int(upp[j]) for j in keepu],
                      [float(uvals[j]) for j in keepu]))
        for c in occ:
            w[c] = 0.0
        w[i] = 0.0
    return (
        np.asarray(Lp, np.int64), np.asarray(Li, np.int64),
        np.asarray(Lx, np.float64),
        np.asarray(Up, np.int64), np.asarray(Ui, np.int64),
        np.asarray(Ux, np.float64), diag,
    )


def ilu_from_arrays(l_cols, l_vals, l_rows, l_starts, l_counts,
                    u_cols, u_vals, u_rows, u_starts, u_counts, inv_diag,
                    n_pad: int, dtype=torch.float32,
                    device=None) -> ILU0Preconditioner:
    """The device apply from solve-ordered factor arrays (host arrays or
    tensors): ``*_cols``/``*_vals`` (R, K), ``*_rows`` (R,), the level
    windows ``*_starts``/``*_counts``, ``inv_diag`` (n_pad,).  Row entries
    >= ``n_pad`` (JAX's window padding) are never in a level's window."""
    dev = resolve_device(device)

    def t(a, dt):
        return torch.as_tensor(np.array(a)).to(device=dev, dtype=dt)

    inv_d = t(inv_diag, dtype)
    return ILU0Preconditioner(
        l_levels=_levels(t(l_cols, torch.int64), t(l_vals, dtype),
                         t(l_rows, torch.int64), np.asarray(l_starts),
                         np.asarray(l_counts), None),
        u_levels=_levels(t(u_cols, torch.int64), t(u_vals, dtype),
                         t(u_rows, torch.int64), np.asarray(u_starts),
                         np.asarray(u_counts), inv_d),
        inv_diag=inv_d,
        n_pad=int(n_pad),
    )


def _build_tri_precond(Lp, Li, Lx, Up, Ui, Ux, diag_vals, n, n_pad, dtype,
                       device) -> ILU0Preconditioner:
    if n_pad is None:
        n_pad = pad_to(max(n, 1))
    l_level, l_nlev = _tri_levels(Lp, Li, n, lower=True)
    u_level, u_nlev = _tri_levels(Up, Ui, n, lower=False)
    l_order = np.argsort(l_level, kind="stable").astype(np.int64)
    u_order = np.argsort(u_level, kind="stable").astype(np.int64)
    lc, lv, lr, ls, lcnt = _pack_tri_levels(l_order, l_level, l_nlev, Lp, Li,
                                            Lx)
    uc, uv, ur, us, ucnt = _pack_tri_levels(u_order, u_level, u_nlev, Up, Ui,
                                            Ux)
    inv_d = np.ones(n_pad, dtype=np.float64)
    inv_d[:n] = 1.0 / diag_vals
    return ilu_from_arrays(lc, lv, lr, ls, lcnt, uc, uv, ur, us, ucnt, inv_d,
                           n_pad, dtype=dtype, device=device)
