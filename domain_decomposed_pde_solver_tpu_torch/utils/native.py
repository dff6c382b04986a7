"""ctypes loader for the native host kernels (``native/ddps_native.cpp``).

The reference's host pipeline is C++; ours is too where it's hot: adjacency
construction, dual-graph build, AMG aggregation, RCM ordering, ELL packing.
The library is compiled on demand with g++ from the repository's shared
source into this package's own build directory (``build/native/``, never
next to the source: the JAX package's loader owns that copy), and every
entry point has a NumPy fallback, so the framework works without a
toolchain.  The port needs the native library for parity with the JAX
package: the NumPy fallback of :func:`aggregate_greedy_filtered_native` may
choose different aggregates.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["load_native", "native_available"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "ddps_native.cpp"
_SO = _ROOT / "build" / "native" / "libddps_native.so"

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64


def _compile() -> bool:
    if not _SRC.exists():
        return False
    if _SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return True
    # Build to a private name and rename into place: concurrent test
    # workers may compile at once, and none may load a half-written file.
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    try:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            [
                "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                "-o", str(tmp), str(_SRC),
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def load_native() -> Optional[ctypes.CDLL]:
    """Compile (if needed) and load the native library; None on failure."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("DDPS_NO_NATIVE"):
            return None
        if not _compile():
            return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:
            return None
        lib.node_adjacency.restype = _i64
        lib.node_adjacency.argtypes = [_i64p, _i64, _i64, _i64, _i64p, ctypes.c_void_p]
        lib.node_adjacency_cap.restype = _i64
        lib.node_adjacency_cap.argtypes = [
            _i64p, _i64, _i64, _i64, _i64, _i64p, _i64p,
        ]
        lib.node_adjacency_cap_i32.restype = _i64
        lib.node_adjacency_cap_i32.argtypes = [
            _i32p, _i64, _i64, _i64, _i64, _i64p, _i32p,
        ]
        lib.dual_graph.restype = _i64
        lib.dual_graph.argtypes = [_i64p, _i64, _i64, _i64, _i64, _i64p, ctypes.c_void_p]
        lib.aggregate_greedy.restype = _i64
        lib.aggregate_greedy.argtypes = [_i64p, _i64p, _i64, _i64p]
        lib.aggregate_greedy_filtered.restype = _i64
        lib.aggregate_greedy_filtered.argtypes = [
            _i64p, _i64p, _f64p, _f64p, ctypes.c_double, _i64, _i64p,
        ]
        lib.aggregate_greedy_filtered_i32.restype = _i64
        lib.aggregate_greedy_filtered_i32.argtypes = [
            _i64p, _i32p, _f64p, _f64p, ctypes.c_double, _i64, _i64p,
        ]
        lib.rcm_order.restype = None
        lib.rcm_order.argtypes = [_i64p, _i64p, _i64, _i64p]
        lib.pack_ell_f32.restype = None
        lib.pack_ell_f32.argtypes = [_i64p, _i64p, _f64p, _i64, _i64, _i64, _i32p, _f32p]
        lib.pack_ell_f64.restype = None
        lib.pack_ell_f64.argtypes = [_i64p, _i64p, _f64p, _i64, _i64, _i64, _i32p, _f64p]
        lib.ilu0.restype = _i64
        lib.ilu0.argtypes = [_i64p, _i64p, _f64p, _i64, _i64p]
        lib.tri_levels.restype = _i64
        lib.tri_levels.argtypes = [_i64p, _i64p, _i64, _i64, _i64p]
        lib.rap_galerkin.restype = _i64
        lib.rap_galerkin.argtypes = [
            _i64p, _i64p, _f64p, _i64p, _i64p, _f64p, _i64, _i64, _i64p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.pack_dia_f32.restype = _i64
        lib.pack_dia_f32.argtypes = [
            _i64p, _i64p, _f64p, _i64, _i64, _i64, _i64p, ctypes.c_void_p,
        ]
        lib.sa_prolongator.restype = _i64
        lib.sa_prolongator.argtypes = [
            _i64p, _i64p, _f64p, _i64p, _f64p, _f64p, _i64, _i64, _i64p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.sa_prolongator_i32.restype = _i64
        lib.sa_prolongator_i32.argtypes = [
            _i64p, _i32p, _f64p, _i32p, _f64p, _f64p, _i64, _i64, _i64p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.assemble_from_conn.restype = _i64
        lib.assemble_from_conn.argtypes = [
            _i64p, _i64, _i64, _i64, _u8p, _i64p, _f64p, _i64, _i64,
            _i64p, _i64p, _f64p, _f64p, _i64p, _i64p, _i64p,
        ]
        lib.assemble_from_conn_i32.restype = _i64
        lib.assemble_from_conn_i32.argtypes = [
            _i32p, _i64, _i64, _i64, _u8p, _i32p, _f64p, _i64, _i64,
            _i64p, _i32p, _f64p, _f64p, _i32p, _i32p, _i64p,
        ]
        lib.bf16_exact.restype = _i64
        lib.bf16_exact.argtypes = [_f64p, _i64]
        lib.bsg_assign.restype = _i64
        lib.bsg_assign.argtypes = [_i64p, _i64p, _i64, _i64, _i64, _i64, _i64p]
        _i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        lib.assemble_structured.restype = None
        lib.assemble_structured.argtypes = [
            _i64, _i64, _i64, _i64, _i64p, _i64, _i64, _f64p, _i64p, _i64p,
            ctypes.c_double, ctypes.c_double, _i64p, _i32p, _f64p, _f64p,
            _f64p,
        ]
        lib.bsg_canonical_order.restype = None
        lib.bsg_canonical_order.argtypes = [_i64p, _i64p, _i64p, _i64, _i64p]
        lib.bsg_canonical_order_i32.restype = None
        lib.bsg_canonical_order_i32.argtypes = [_i64p, _i32p, _i64p, _i64, _i64p]
        lib.bsg_fill.restype = None
        lib.bsg_fill.argtypes = [
            _i64p, _i64p, _f64p, _i64p, _i64, _i64, _i64, _i64, _i64,
            _i32p, _i8p, _i8p, _f32p, _f32p,
        ]
        lib.ilut.restype = _i64
        lib.ilut.argtypes = [
            _i64p, _i64p, _f64p, _i64, ctypes.c_double, ctypes.c_double,
            _i64p, _i64p, _f64p, _i64p, _i64p, _f64p, _f64p,
        ]
        lib.stencil_verify_corr.restype = _i64
        lib.stencil_verify_corr.argtypes = [
            _f32p, _i64, _i64, _i64, _i64, _i64, _i64, _i64p, _i64,
            _f32p, _f32p,
        ]
        lib.assemble_reduced.restype = _i64
        lib.assemble_reduced.argtypes = [
            _i64p, _i64p, _i64, _u8p, _i64p, _f64p, _i64p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.assemble_reduced_i32.restype = _i64
        lib.assemble_reduced_i32.argtypes = [
            _i64p, _i32p, _i64, _u8p, _i32p, _f64p, _i64p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.pack_dia_f32_i32.restype = _i64
        lib.pack_dia_f32_i32.argtypes = [
            _i64p, _i32p, _f64p, _i64, _i64, _i64, _i64p, ctypes.c_void_p,
        ]
        lib.rap_run.restype = _i64
        lib.rap_run.argtypes = [
            _i64p, _i64p, _f64p, _i64p, _i64p, _f64p, _i64, _i64,
        ]
        lib.rap_fetch.restype = None
        lib.rap_fetch.argtypes = [_i64p, _i64p, _f64p]
        lib.rap_run_i32.restype = _i64
        lib.rap_run_i32.argtypes = [
            _i64p, _i32p, _f64p, _i64p, _i32p, _f64p, _i64, _i64,
        ]
        lib.rap_fetch_i32.restype = None
        lib.rap_fetch_i32.argtypes = [_i64p, _i32p, _f64p]
        lib.gersh_dinv.restype = ctypes.c_double
        lib.gersh_dinv.argtypes = [_i64p, _i64p, _f64p, _i64]
        lib.gersh_dinv_i32.restype = ctypes.c_double
        lib.gersh_dinv_i32.argtypes = [_i64p, _i32p, _f64p, _i64]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None


# ---------------------------------------------------------------------------
# High-level wrappers (native with NumPy semantics)
# ---------------------------------------------------------------------------


def node_adjacency_native(conn: np.ndarray, n: int):
    """Deduplicated directed node adjacency as (indptr, indices); None if the
    native library is unavailable.  ``conn``: (num_elem, npe) int64.

    Tries a single capacity-bounded pass first (an over-estimate of 2x the
    incidence degree covers every FEM mesh in practice); falls back to the
    two-pass count+fill form — the incidence build and per-node dedup
    dominate, so one pass halves the cost (~22 s at 10M DOF)."""
    lib = load_native()
    if lib is None:
        return None
    # int32 fast path: conn already int32 (box_mesh emits it) and every id
    # fits — halves the conn/incidence/indices traffic, which is what the
    # kernel is bound by on this host (first-touch faults + cache misses).
    use_i32 = (
        conn.dtype == np.int32 and n < 2**31 and conn.shape[0] < 2**31
    )
    idt = np.int32 if use_i32 else np.int64
    conn = np.ascontiguousarray(conn, dtype=idt)
    num_elem, npe = conn.shape
    indptr = np.zeros(n + 1, dtype=np.int64)
    # 32 unique neighbors/node covers linear elements (tets ~15, hex ~26);
    # denser connectivity (HEX27 etc.) falls back to the two-pass form.
    cap = min(num_elem * npe * (npe - 1), 32 * n)
    indices = np.empty(max(cap, 1), dtype=idt)
    fn = lib.node_adjacency_cap_i32 if use_i32 else lib.node_adjacency_cap
    nnz = fn(conn, num_elem, npe, n, cap, indptr, indices)
    if nnz >= 0:
        # Contiguous view, no copy: the untouched tail pages of the
        # over-allocated buffer never fault, so physical memory ~= nnz*8.
        return indptr, indices[:nnz]
    conn = np.ascontiguousarray(conn, dtype=np.int64)
    nnz = lib.node_adjacency(conn, num_elem, npe, n, indptr, None)
    indices = np.zeros(nnz, dtype=np.int64)
    lib.node_adjacency(
        conn, num_elem, npe, n, indptr, indices.ctypes.data_as(ctypes.c_void_p)
    )
    return indptr, indices


def assemble_reduced_native(adj_ptr, adj_idx, n, free_mask, node_to_free,
                            bval, n_free):
    """Reduced Laplacian (indptr, indices, data, b, bdry_rows, bdry_cols)
    from the node adjacency in two native passes; None if unavailable.
    Replaces ~15 nnz-sized NumPy passes in
    :func:`models.heat.assemble_heat_system`."""
    lib = load_native()
    if lib is None:
        return None
    # int32 fast path when the adjacency indices are already int32 (the
    # capacity-bounded adjacency above emits them for int32 conn): halves
    # the dominant output streams (indices + boundary pairs).
    use_i32 = (
        np.asarray(adj_idx).dtype == np.int32 and n < 2**31
    )
    idt = np.int32 if use_i32 else np.int64
    adj_ptr = np.ascontiguousarray(adj_ptr, np.int64)
    adj_idx = np.ascontiguousarray(adj_idx, idt)
    free_mask = np.ascontiguousarray(free_mask, np.uint8)
    node_to_free = np.ascontiguousarray(node_to_free, idt)
    bval = np.ascontiguousarray(bval, np.float64)
    indptr = np.zeros(n_free + 1, dtype=np.int64)
    fn = lib.assemble_reduced_i32 if use_i32 else lib.assemble_reduced
    nnz = fn(
        adj_ptr, adj_idx, n, free_mask, node_to_free, bval, indptr,
        None, None, None, None, None,
    )
    # boundary pairs = sum of free-row adjacency degrees - off-diag count
    free_deg = (
        adj_ptr[1:][free_mask.view(bool)] - adj_ptr[:-1][free_mask.view(bool)]
    )
    nbdry = int(free_deg.sum()) - (nnz - n_free)
    indices = np.empty(nnz, dtype=idt)
    data = np.empty(nnz, dtype=np.float64)
    b = np.zeros(n_free, dtype=np.float64)
    bdry_rows = np.empty(nbdry, dtype=idt)
    bdry_cols = np.empty(nbdry, dtype=idt)
    fn(
        adj_ptr, adj_idx, n, free_mask, node_to_free, bval, indptr,
        indices.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p),
        b.ctypes.data_as(ctypes.c_void_p),
        bdry_rows.ctypes.data_as(ctypes.c_void_p),
        bdry_cols.ctypes.data_as(ctypes.c_void_p),
    )
    return indptr, indices, data, b, bdry_rows, bdry_cols


def assemble_from_conn_native(conn, n, free_mask, node_to_free, bval, n_free):
    """Fused adjacency + reduced-Laplacian assembly straight from the
    element connectivity: (indptr, indices, data, b, bdry_rows, bdry_cols),
    or None (library unavailable, or a row wider than the capacity bound —
    caller falls back to the two-kernel node_adjacency + assemble_reduced
    path, which is byte-identical).  Skips materializing the ~1.15 GB node
    adjacency CSR at 10M DOF and never computes boundary-node rows."""
    lib = load_native()
    if lib is None or conn.shape[0] == 0:
        return None
    num_elem, npe = conn.shape
    use_i32 = (
        conn.dtype == np.int32 and n < 2**31 and num_elem < 2**31
    )
    idt = np.int32 if use_i32 else np.int64
    conn = np.ascontiguousarray(conn, idt)
    free_mask = np.ascontiguousarray(free_mask, np.uint8)
    node_to_free = np.ascontiguousarray(node_to_free, idt)
    bval = np.ascontiguousarray(bval, np.float64)
    # Same 32-unique-neighbors capacity heuristic as node_adjacency_native;
    # the over-allocation is virtual only (untouched tail pages never
    # fault), so physical memory ~= nnz.
    cap = min(num_elem * npe * (npe - 1), 32 * n) + n_free
    indptr = np.zeros(n_free + 1, dtype=np.int64)
    indices = np.empty(max(cap, 1), dtype=idt)
    data = np.empty(max(cap, 1), dtype=np.float64)
    b = np.zeros(max(n_free, 1), dtype=np.float64)
    bdry_rows = np.empty(max(cap, 1), dtype=idt)
    bdry_cols = np.empty(max(cap, 1), dtype=idt)
    nb_out = np.zeros(1, dtype=np.int64)
    fn = lib.assemble_from_conn_i32 if use_i32 else lib.assemble_from_conn
    nnz = fn(
        conn, num_elem, npe, n, free_mask, node_to_free, bval, cap, cap,
        indptr, indices, data, b, bdry_rows, bdry_cols, nb_out,
    )
    if nnz < 0:
        return None
    nb = int(nb_out[0])
    return (
        indptr, indices[:nnz], data[:nnz], b[:n_free],
        bdry_rows[:nb], bdry_cols[:nb],
    )


def stencil_verify_corr_native(data, dims, period, taps, diag_idx, pats):
    """Exact per-entry stencil verification + correction extraction on the
    packed (ndiags, n_pad) f32 DIA array; (ok, corr) or None if unavailable.
    ``pats``: (period^3, ndiags) f32 class table."""
    lib = load_native()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.float32)
    taps_a = np.ascontiguousarray(np.asarray(taps, np.int64).reshape(-1, 3))
    pats = np.ascontiguousarray(pats, np.float32)
    mx, my, mz = (int(v) for v in dims)
    corr = np.empty(mx * my * mz, dtype=np.float32)
    ok = lib.stencil_verify_corr(
        data, data.shape[1], data.shape[0], mx, my, mz, int(period),
        taps_a, int(diag_idx), pats, corr,
    )
    return bool(ok), corr


def dual_graph_native(conn: np.ndarray, n: int, ncommon: int):
    lib = load_native()
    if lib is None:
        return None
    conn = np.ascontiguousarray(conn, dtype=np.int64)
    num_elem, npe = conn.shape
    indptr = np.zeros(num_elem + 1, dtype=np.int64)
    nnz = lib.dual_graph(conn, num_elem, npe, n, ncommon, indptr, None)
    indices = np.zeros(nnz, dtype=np.int64)
    lib.dual_graph(
        conn, num_elem, npe, n, ncommon, indptr,
        indices.ctypes.data_as(ctypes.c_void_p),
    )
    return indptr, indices


def aggregate_greedy_filtered_native(indptr, indices, data, diag,
                                     theta: float, n: int):
    """Strength-filtered greedy aggregation off the raw CSR (no
    materialized filtered graph).  Returns (agg, n_agg) or None."""
    lib = load_native()
    if lib is None:
        return None
    agg = np.zeros(n, dtype=np.int64)
    indptr = np.ascontiguousarray(indptr, np.int64)
    data = np.ascontiguousarray(data, np.float64)
    diag = np.ascontiguousarray(diag, np.float64)
    if indices.dtype == np.int32:
        n_agg = lib.aggregate_greedy_filtered_i32(
            indptr, np.ascontiguousarray(indices), data, diag,
            float(theta), n, agg,
        )
    else:
        n_agg = lib.aggregate_greedy_filtered(
            indptr, np.ascontiguousarray(indices, np.int64), data, diag,
            float(theta), n, agg,
        )
    return agg, int(n_agg)


def aggregate_greedy_native(indptr: np.ndarray, indices: np.ndarray, n: int):
    lib = load_native()
    if lib is None:
        return None
    agg = np.zeros(n, dtype=np.int64)
    n_agg = lib.aggregate_greedy(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int64),
        n,
        agg,
    )
    return agg, int(n_agg)


def rcm_order_native(indptr: np.ndarray, indices: np.ndarray, n: int):
    lib = load_native()
    if lib is None:
        return None
    perm = np.zeros(n, dtype=np.int64)
    lib.rcm_order(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int64),
        n,
        perm,
    )
    return perm


def ilu0_native(indptr, indices, data, n):
    """In-place ILU(0) on a column-sorted CSR; returns (lu_data, diag_pos)
    or None if the native library is unavailable.  Raises on zero pivot."""
    lib = load_native()
    if lib is None:
        return None
    lu = np.ascontiguousarray(data, np.float64).copy()
    diag_pos = np.zeros(n, dtype=np.int64)
    rc = lib.ilu0(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int64),
        lu, n, diag_pos,
    )
    if rc != 0:
        raise ZeroDivisionError(f"ILU(0): zero pivot at row {int(rc) - 1}")
    return lu, diag_pos


def tri_levels_native(indptr, indices, n, lower: bool):
    """Level schedule for a triangular solve; (levels, n_levels) or None."""
    lib = load_native()
    if lib is None:
        return None
    level = np.zeros(n, dtype=np.int64)
    nlev = lib.tri_levels(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int64),
        n, 1 if lower else 0, level,
    )
    return level, int(nlev)


def rap_galerkin_native(Ap, Ai, Ax, Pp, Pi, Px, n_f, n_c):
    """C = P^T A P as (indptr, indices, data); None if unavailable.

    Single numeric pass (``rap_run`` stashes, ``rap_fetch`` copies out) —
    the two-call count+fill protocol recomputed the whole triple product,
    which at 10M-DOF fine levels doubled the ~6 s RAP phase.  int32 index
    fast path when both matrices fit.
    """
    lib = load_native()
    if lib is None:
        return None
    Ap = np.ascontiguousarray(Ap, np.int64)
    Ax = np.ascontiguousarray(Ax, np.float64)
    Pp = np.ascontiguousarray(Pp, np.int64)
    Px = np.ascontiguousarray(Px, np.float64)
    if max(n_f, n_c) < 2**31:
        Ai = np.ascontiguousarray(Ai, np.int32)
        Pi = np.ascontiguousarray(Pi, np.int32)
        nnz = lib.rap_run_i32(Ap, Ai, Ax, Pp, Pi, Px, n_f, n_c)
        Cp = np.zeros(n_c + 1, dtype=np.int64)
        Ci = np.zeros(nnz, dtype=np.int32)
        Cx = np.zeros(nnz, dtype=np.float64)
        lib.rap_fetch_i32(Cp, Ci, Cx)
        return Cp, Ci.astype(np.int64), Cx
    Ai = np.ascontiguousarray(Ai, np.int64)
    Pi = np.ascontiguousarray(Pi, np.int64)
    nnz = lib.rap_run(Ap, Ai, Ax, Pp, Pi, Px, n_f, n_c)
    Cp = np.zeros(n_c + 1, dtype=np.int64)
    Ci = np.zeros(nnz, dtype=np.int64)
    Cx = np.zeros(nnz, dtype=np.float64)
    lib.rap_fetch(Cp, Ci, Cx)
    return Cp, Ci, Cx


def gersh_dinv_native(indptr, indices, data, n) -> Optional[float]:
    """Gershgorin bound of lambda_max(D^-1 A); None if unavailable.

    One streaming pass; a guaranteed containment bound for the Chebyshev
    interval (vs. the power method's underestimate-then-pad-5%).
    """
    lib = load_native()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    data = np.ascontiguousarray(data, np.float64)
    if n < 2**31:
        indices32 = np.ascontiguousarray(indices, np.int32)
        return float(lib.gersh_dinv_i32(indptr, indices32, data, n))
    indices = np.ascontiguousarray(indices, np.int64)
    return float(lib.gersh_dinv(indptr, indices, data, n))


def sa_prolongator_native(Ap, Ai, Ax, agg, tval, s_over_d, n_f, n_c):
    """P = (I - s D^-1 A) T as (indptr, indices, data); None if unavailable.

    int32 index fast path when the matrix indices are already int32 (the
    10M assembly emits them): the former unconditional int64 conversion
    allocated ~1 GB of fresh pages and dominated AMG setup on this
    fault-rate-limited host (~24 s of a 32 s total)."""
    lib = load_native()
    if lib is None:
        return None
    Ap = np.ascontiguousarray(Ap, np.int64)
    Ax = np.ascontiguousarray(Ax, np.float64)
    tval = np.ascontiguousarray(tval, np.float64)
    s_over_d = np.ascontiguousarray(s_over_d, np.float64)
    Pp = np.zeros(n_f + 1, dtype=np.int64)
    use_i32 = np.asarray(Ai).dtype == np.int32 and max(n_f, n_c) < 2**31
    idt = np.int32 if use_i32 else np.int64
    fn = lib.sa_prolongator_i32 if use_i32 else lib.sa_prolongator
    Ai = np.ascontiguousarray(Ai, idt)
    agg = np.ascontiguousarray(agg, idt)
    nnz = fn(Ap, Ai, Ax, agg, tval, s_over_d, n_f, n_c, Pp, None, None)
    Pi = np.zeros(nnz, dtype=idt)
    Px = np.zeros(nnz, dtype=np.float64)
    fn(
        Ap, Ai, Ax, agg, tval, s_over_d, n_f, n_c, Pp,
        Pi.ctypes.data_as(ctypes.c_void_p), Px.ctypes.data_as(ctypes.c_void_p),
    )
    return Pp, Pi, Px


def bf16_exact_native(data):
    """1/0 bf16-roundtrip exactness, or None if unavailable."""
    lib = load_native()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.float64)
    return bool(lib.bf16_exact(data, data.size))


def ilut_native(indptr, indices, data, n, fill_factor, droptol):
    """ILUT factorization: (Lp, Li, Lx, Up, Ui, Ux, diag) or None.
    Raises ZeroDivisionError on a zero pivot."""
    lib = load_native()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    data = np.ascontiguousarray(data, np.float64)
    lens = np.diff(indptr)
    caps = np.maximum(1, np.ceil(fill_factor * lens).astype(np.int64))
    cap_total = int(caps.sum())
    Lp = np.zeros(n + 1, np.int64)
    Up = np.zeros(n + 1, np.int64)
    Li = np.zeros(cap_total, np.int64)
    Lx = np.zeros(cap_total, np.float64)
    Ui = np.zeros(cap_total, np.int64)
    Ux = np.zeros(cap_total, np.float64)
    diag = np.zeros(n, np.float64)
    rc = lib.ilut(
        indptr, indices, data, n, float(fill_factor), float(droptol),
        Lp, Li, Lx, Up, Ui, Ux, diag,
    )
    if rc != 0:
        raise ZeroDivisionError(f"ILUT: zero pivot at row {int(rc) - 1}")
    return (
        Lp, Li[: Lp[n]], Lx[: Lp[n]], Up, Ui[: Up[n]], Ux[: Up[n]], diag
    )


def bsg_assign_native(rows, cols, tile, subl, lanes):
    """BSG micro-op assignment: (mo_index, max_mo), or None if unavailable.
    rows/cols must be sorted by (row, col) in the internal numbering."""
    lib = load_native()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    mo_index = np.zeros(rows.size, dtype=np.int64)
    max_mo = lib.bsg_assign(rows, cols, rows.size, tile, subl, lanes, mo_index)
    if max_mo < 0:
        return None  # pathological group needed > 256 rounds
    return mo_index, int(max_mo)


def bsg_canonical_order_native(indptr, indices, perm, n):
    """Entry order such that (perm[row], perm[col]) is lexsorted, or None.

    Replaces ``np.lexsort`` over two nnz-sized int64 keys in the BSG packer
    (bucket by permuted row + per-row column sorts)."""
    lib = load_native()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    perm = np.ascontiguousarray(perm, np.int64)
    order = np.empty(int(indptr[-1]), dtype=np.int64)
    if np.asarray(indices).dtype == np.int32:
        lib.bsg_canonical_order_i32(
            indptr, np.ascontiguousarray(indices, np.int32), perm, n, order
        )
    else:
        lib.bsg_canonical_order(
            indptr, np.ascontiguousarray(indices, np.int64), perm, n, order
        )
    return order


def bsg_fill_native(rows, cols, data, mo_index, tile, win_rows, lanes,
                    n_tiles, max_mo, n_pad):
    """Single-pass fill of the BSG arrays; returns (w0, qq, rm, vals, diag)
    or None when the native library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    subl = tile // lanes
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    data = np.ascontiguousarray(data, np.float64)
    mo_index = np.ascontiguousarray(mo_index, np.int64)
    w0 = np.zeros((n_tiles, max_mo), dtype=np.int32)
    qq = np.zeros((n_tiles, max_mo, subl, lanes), dtype=np.int8)
    rm = np.zeros((n_tiles, max_mo, subl, lanes), dtype=np.int8)
    vals = np.zeros((n_tiles, max_mo, subl, lanes), dtype=np.float32)
    diag = np.zeros(n_pad, dtype=np.float32)
    lib.bsg_fill(
        rows, cols, data, mo_index, rows.size, tile, win_rows, lanes,
        max_mo, w0, qq, rm, vals, diag,
    )
    return w0, qq, rm, vals, diag


def pack_dia_native(indptr, indices, data, n, n_pad, max_diags):
    """DIA detection + f32 packing: (offsets, data (ndiags, n_pad) f32),
    "toomany" if the matrix has more than max_diags diagonals, or None if
    the native library is unavailable."""
    lib = load_native()
    if lib is None or n == 0:
        return None
    use_i32 = np.asarray(indices).dtype == np.int32 and n < 2**31
    idt = np.int32 if use_i32 else np.int64
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, idt)
    data = np.ascontiguousarray(data, np.float64)
    offsets = np.zeros(max_diags + 1, dtype=np.int64)
    fn = lib.pack_dia_f32_i32 if use_i32 else lib.pack_dia_f32
    nd = fn(indptr, indices, data, n, n_pad, max_diags, offsets, None)
    if nd < 0:
        return "toomany"
    out = np.zeros((nd, n_pad), dtype=np.float32)
    fn(
        indptr, indices, data, n, n_pad, nd, offsets,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return offsets[:nd], out


def pack_ell_native(indptr, indices, data, n, n_pad, K, dtype):
    lib = load_native()
    if lib is None:
        return None
    cols = np.zeros((n_pad, K), dtype=np.int32)
    dt = np.dtype(dtype)
    data = np.ascontiguousarray(data, np.float64)
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    if dt == np.float32:
        vals = np.zeros((n_pad, K), dtype=np.float32)
        lib.pack_ell_f32(indptr, indices, data, n, n_pad, K, cols, vals)
    elif dt == np.float64:
        vals = np.zeros((n_pad, K), dtype=np.float64)
        lib.pack_ell_f64(indptr, indices, data, n, n_pad, K, cols, vals)
    else:
        return None
    return cols, vals
