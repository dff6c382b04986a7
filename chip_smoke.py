#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``domain_decomposed_pde_solver_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; no phase catches an
error and carries on).  Each path is driven with every kernel launch
counter at 0 just before it and read just after:

1. Require CUDA; print the card's name and power limit from ``nvidia-smi``.
2. Build every kernel of the port from ``csrc/`` into ``build/kernels/``,
   one ``nvcc`` per source, all started together.
A. The structured path at full width: write ``box_mesh(100, 100, 100,
   "TETRA4")`` (1,009,899 free DOF) to ``build/chip_smoke/box100.exo`` and
   run the port's ``cli.solve.main`` on it in this process (f64, AMG, no
   snapshots, tolerance 1e-8: f32 CG+AMG sweeps on the pad-stencil
   operator with the f64 residual on the card).  Require exit code 0, a
   ``PadStencilOperator`` level 0 and a ``DIAMatrix`` level 1, launches of
   the pad-stencil kernel in f32 and f64 and of the DIA kernel, and the
   answer read back from the solution file with a host f64 relative
   residual <= 1.5e-8 and every value within [100, 1000].
B. The CLI's default route at smaller depth: ``box_mesh(20, 20, 20,
   "TETRA4")``, f64, Jacobi, per-iteration snapshots, tolerance 1e-10: the
   fine operator is DIA with bf16 storage and f64 vectors (the DIA
   kernel); the solution file holds iterations + 1 timesteps.
C. Slice 1's unstructured path as it was: the 833,048-DOF refined tet box
   (``refine_uniform(box_mesh(49, 49, 49, "TETRA4"), 1)``) through
   ``SteadyHeatSolver(..., dtype=float32, precond="amg")``, two solves, on
   the sliced-ELL kernel; answers checked as before.
D. Every kernel against its plain PyTorch version on the card, on the
   paths' operators and a few more shapes (relative error limit 1e-5 in
   f32, 1e-12 in f64: the same products summed in another order, with
   fused multiply-adds).  These launches do not count.
E. Times with CUDA events: each kernel on its path's shape, its plain
   version and, as a yardstick the port never calls, one PyTorch call
   computing the same product (cuSPARSE through ``torch.sparse_csr_tensor
   @ x``); the 1M pad-stencil product also with L2 flushed between calls.
   Print the kernel record, the card line and the device record as the
   last line.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
OUT = REPO / "build" / "chip_smoke"
BOX = 100  # box_mesh(100, 100, 100, "TETRA4") -> 1,009,899 free DOF
BOX_DOF = 1_009_899
SMALL_BOX = 20
MESH_CELLS = 49  # refine_uniform(box_mesh(49, 49, 49)) -> 833,048 free DOF
TOL_F32 = 1e-5
TOL_F64 = 1e-12
BC2 = {100: 80.0, 1000: 25.0}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet, at 700 W
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
REPLACES = {
    "sell_spmv": "domain_decomposed_pde_solver_tpu/ops/bsg.py:822",
    "pad_stencil": "domain_decomposed_pde_solver_tpu/ops/pallas/stencil_kernel.py:421",
    "dia_spmv": "domain_decomposed_pde_solver_tpu/ops/pallas/dia_kernel.py:45",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0]


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_counts(kernels) -> None:
    for k in kernels:
        k.reset()


def read_counts(kernels) -> dict:
    return {k.name: {"launches": k.launches,
                     "by_entry": {e: n for e, n in k.by_entry.items() if n}}
            for k in kernels}


def host_relres(A, u, b) -> float:
    import numpy as np

    r = b - A.matvec(np.asarray(u, dtype=np.float64))
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def bound(bytes_moved: float, flops: float) -> tuple:
    """Least time on the card (ms) and what bounds it: bytes over the
    HBM rate against flops over the f32 rate."""
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------------------
# A. The structured path, at full width, through the port's CLI
# ---------------------------------------------------------------------------


def run_cli(args, report, kernels):
    from domain_decomposed_pde_solver_tpu_torch.cli.solve import main

    reset_counts(kernels)
    t0 = time.perf_counter()
    rc = main([str(a) for a in args], report=report)
    wall = time.perf_counter() - t0
    return rc, wall, read_counts(kernels)


def phase_a(kernels, box: int = BOX, extra_args=()) -> dict:
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.io import (
        box_mesh,
        read_nodal_vars,
        write_exodus,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import DIAMatrix
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        PadStencilOperator,
    )

    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    mesh = box_mesh(box, box, box, "TETRA4")
    t_mesh = time.perf_counter() - t0
    path = OUT / f"box{box}.exo"
    t0 = time.perf_counter()
    write_exodus(str(path), mesh)
    t_write = time.perf_counter() - t0
    log(f"[A] box_mesh({box},{box},{box},TETRA4): {mesh.num_nodes} nodes, "
        f"{mesh.num_elem} elements, built {t_mesh:.2f} s, written "
        f"{t_write:.2f} s ({path.stat().st_size / 1e6:.1f} MB)")
    del mesh
    sol = OUT / f"box{box}_solution.exo"
    rep = {}
    rc, wall, counts = run_cli(
        ["--input", path, "--solution", sol, "--dtype", "float64",
         "--precond", "amg", "--no-snapshots", "--tolerance", "1e-8",
         "--verbose", *extra_args], rep, kernels)
    check(rc == 0, f"[A] the CLI exited with {rc}")
    sy, A, M, mr = rep["system"], rep["operator"], rep["precond"], rep["mixed"]
    levels = [(lvl.n_rows, type(lvl.A).__name__, type(lvl.P).__name__)
              for lvl in M.levels]
    log(f"[A] CLI wall {wall:.3f} s; hierarchy {levels} + coarse "
        f"{tuple(M.coarse_inv.shape)}")
    log(f"[A] sweeps {mr.refinements}, inner iterations "
        f"{mr.inner_iterations}, relres {mr.relres:.3e}, timings "
        f"{json.dumps(mr.timings)}")
    log(f"[A] launches per solve: {json.dumps(counts)}")
    if box == BOX:
        check(sy.n_free == BOX_DOF, f"[A] {sy.n_free} free DOF")
    check(isinstance(A, PadStencilOperator) and M.levels[0].A is A,
          f"[A] level 0 is {levels[0][1]}")
    check(len(M.levels) > 1 and isinstance(M.levels[1].A, DIAMatrix),
          f"[A] level 1 is not DIA: {levels}")
    by = counts["pad_stencil"]["by_entry"]
    if A.device.type == "cuda":
        check(by.get("ddps_pad_stencil_f32_bf16", 0) > 0,
              "[A] the f32 pad-stencil kernel was not launched")
        check(by.get("ddps_pad_stencil_f64_bf16", 0) > 0,
              "[A] the f64 pad-stencil kernel was not launched")
        check(counts["dia_spmv"]["launches"] > 0,
              "[A] the DIA kernel was not launched")
    names, times, vals = read_nodal_vars(str(sol))
    check(vals.shape[0] == 2, f"[A] {vals.shape[0]} timesteps in the file")
    u = vals[-1, 0, sy.free_to_node]
    check(bool(np.isfinite(vals).all()), "[A] non-finite values in the file")
    rr = host_relres(sy.A, u, sy.b)
    log(f"[A] read back: host f64 relres {rr:.3e} (limit 1.5e-8), values "
        f"[{vals[-1, 0].min():.6f}, {vals[-1, 0].max():.6f}]")
    check(rr <= 1.5e-8, f"[A] host relres {rr:.3e} > 1.5e-8")
    check(100.0 <= float(vals[-1, 0].min()) and float(vals[-1, 0].max()) <= 1000.0,
          "[A] values outside [100, 1000]")
    return dict(report=rep, counts=counts, wall=wall, host_relres=rr,
                levels=levels)


# ---------------------------------------------------------------------------
# B. The CLI's default route (f64, Jacobi, snapshots) at smaller depth
# ---------------------------------------------------------------------------


def phase_b(kernels, box: int = SMALL_BOX, extra_args=()) -> dict:
    import torch

    from domain_decomposed_pde_solver_tpu_torch.io import (
        box_mesh,
        read_nodal_vars,
        write_exodus,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import DIAMatrix

    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"box{box}.exo"
    write_exodus(str(path), box_mesh(box, box, box, "TETRA4"))
    sol = OUT / f"box{box}_solution.exo"
    rep = {}
    rc, wall, counts = run_cli(
        ["--input", path, "--solution", sol, "--dtype", "float64",
         "--precond", "jacobi", "--tolerance", "1e-10", *extra_args],
        rep, kernels)
    check(rc == 0, f"[B] the CLI exited with {rc}")
    A, res, sy = rep["operator"], rep["result"], rep["system"]
    check(isinstance(A, DIAMatrix) and A.data.dtype == torch.bfloat16
          and A.dtype == torch.float64,
          f"[B] fine operator {type(A).__name__}")
    if A.device.type == "cuda":
        check(counts["dia_spmv"]["by_entry"].get("ddps_dia_spmv_bf16_f64", 0)
              > 0, "[B] the bf16/f64 DIA kernel was not launched")
    _names, times, vals = read_nodal_vars(str(sol))
    check(len(times) == res.iterations + 1,
          f"[B] {len(times)} timesteps for {res.iterations} iterations")
    rr = host_relres(sy.A, vals[-1, 0, sy.free_to_node], sy.b)
    log(f"[B] box_mesh({box},{box},{box}) {sy.n_free} DOF: {res.iterations} "
        f"iterations, {len(times)} timesteps, host relres {rr:.3e}, wall "
        f"{wall:.3f} s, launches {json.dumps(counts)}")
    check(rr <= 1e-9, f"[B] host relres {rr:.3e} > 1e-9")
    return dict(report=rep, counts=counts)


# ---------------------------------------------------------------------------
# C. Slice 1's unstructured path
# ---------------------------------------------------------------------------


def phase_c(device, kernels, cells: int = MESH_CELLS) -> dict:
    import torch

    from domain_decomposed_pde_solver_tpu_torch import SteadyHeatSolver
    from domain_decomposed_pde_solver_tpu_torch.io import box_mesh, refine_uniform

    t0 = time.perf_counter()
    mesh = refine_uniform(box_mesh(cells, cells, cells, "TETRA4"), 1)
    t_mesh = time.perf_counter() - t0
    reset_counts(kernels)
    t0 = time.perf_counter()
    solver = SteadyHeatSolver(mesh, dtype=torch.float32, precond="amg",
                              device=device)
    sync(device)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    u1, res1 = solver.solve(tol=1e-6, maxiter=200)
    sync(device)
    t_solve1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    u2, res2 = solver.solve(bc=BC2, tol=1e-6, maxiter=200)
    sync(device)
    t_solve2 = time.perf_counter() - t0
    counts = read_counts(kernels)
    sys_, M = solver.system, solver._precond
    log(f"[C] mesh: {mesh.num_nodes} nodes, {sys_.n_free} free DOF, "
        f"{sys_.A.nnz} nnz, {t_mesh:.2f} s")
    log(f"[C] levels: {[lvl.n_rows for lvl in M.levels]} + coarse "
        f"{tuple(M.coarse_inv.shape)}; level ops "
        f"{[type(lvl.A).__name__ for lvl in M.levels]}, transfers "
        f"{[type(lvl.P).__name__ for lvl in M.levels]}")
    log(f"[C] setup (assembly + operator + AMG): {t_setup:.3f} s")
    log(f"[C] solve 1: {res1.iterations} iters, relres {res1.relres:.3e}, "
        f"{t_solve1 * 1e3:.1f} ms")
    log(f"[C] solve 2 (warm, bc {BC2}): {res2.iterations} iters, relres "
        f"{res2.relres:.3e}, {t_solve2 * 1e3:.1f} ms")
    log(f"[C] launches during the path: {json.dumps(counts)}")
    if device.type == "cuda":
        check(counts["sell_spmv"]["launches"] > 0,
              "[C] the sliced-ELL kernel was not launched")
    run = dict(mesh=mesh, solver=solver, u=(u1, u2), res=(res1, res2),
               counts=counts, t_setup=t_setup, t_solve=(t_solve1, t_solve2))
    run["host_relres"], run["floor"] = check_answers_c(run)
    return run


def check_answers_c(run: dict) -> tuple:
    """Convergence, host residual, maximum principle, solution file."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.io import read_nodal_vars

    solver, mesh = run["solver"], run["mesh"]
    sys_ = solver.system
    (u1, u2), (res1, res2) = run["u"], run["res"]
    b1, b2 = solver.rhs_for(None), solver.rhs_for(BC2)
    rr = (host_relres(sys_.A, u1, b1), host_relres(sys_.A, u2, b2))
    # The warm solve starts from u1, ten times the scale of u2: its f32
    # updates round at that scale, and the recursive residual never sees
    # it, so its true residual cannot fall below the f32 rounding floor
    # eps * || |A| |u1| || / ||b2||.
    absA = abs(sys_.A.to_scipy())
    floor = float(np.finfo(np.float32).eps / 2 * np.linalg.norm(
        absA @ np.abs(u1.astype(np.float64))) / np.linalg.norm(b2))
    limits = (2e-6, 2e-6 + floor)
    log(f"[C] host f64 relres: solve 1 {rr[0]:.3e} (limit {limits[0]:.1e}), "
        f"solve 2 {rr[1]:.3e} (limit {limits[1]:.3e}: 2e-6 + f32 "
        f"warm-start floor {floor:.3e})")
    for i, (res, u, r, lim, lo, hi) in enumerate(
        ((res1, u1, rr[0], limits[0], 100.0, 1000.0),
         (res2, u2, rr[1], limits[1], 25.0, 80.0)), 1
    ):
        check(res.converged, f"[C] solve {i} did not converge")
        check(u.shape == (sys_.n_free,), f"[C] solve {i}: shape {u.shape}")
        check(bool(np.isfinite(u).all()), f"[C] solve {i}: non-finite values")
        check(r <= lim, f"[C] solve {i}: host relres {r:.3e} > {lim:.3e}")
        check(lo <= float(u.min()) and float(u.max()) <= hi,
              f"[C] solve {i}: values [{u.min()}, {u.max()}] outside "
              f"[{lo}, {hi}]")
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "solution.exo"
    solver.write_solution(str(path), u1)
    _names, times, vals = read_nodal_vars(str(path))
    check(vals.shape == (2, 1, mesh.num_nodes), f"[C] read back {vals.shape}")
    bnd = solver.boundary_values_for(None)
    check(np.array_equal(vals[0, 0], bnd),
          "[C] timestep 0 is not the boundary snapshot")
    free = sys_.free_to_node
    check(np.array_equal(vals[1, 0, free], u1.astype(np.float64)),
          "[C] timestep 1 does not hold the solution")
    fixed = np.ones(mesh.num_nodes, bool)
    fixed[free] = False
    check(np.array_equal(vals[1, 0, fixed], bnd[fixed]),
          "[C] boundary values changed in the solution step")
    log(f"[C] solution file: {path.name}, {len(times)} timesteps, read back OK")
    return rr, floor


# ---------------------------------------------------------------------------
# D. Kernels against their plain versions
# ---------------------------------------------------------------------------


def _compare(name, y, y_ref, tol, errs, key, mask=None) -> None:
    import torch

    sync(y.device)
    check(tuple(y.shape) == tuple(y_ref.shape), f"{name}: shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    diff = (y.double() - y_ref.double()).abs().max().item()
    rel = diff / max(y_ref.double().abs().max().item(), 1e-300)
    log(f"[D] {name}: {y.numel()} entries, {str(y.dtype)[6:]}, max rel err "
        f"{rel:.3e} (limit {tol:.0e})")
    check(rel <= tol, f"[D] {name}: kernel disagrees with plain ({rel:.3e})")
    if mask is not None:
        check(not bool(torch.any(y[mask])), f"[D] {name}: a pad slot is not 0")
    errs[key] = max(errs.get(key, 0.0), diff)


def _pad_operator(shape, elem, device):
    import torch

    from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
    from domain_decomposed_pde_solver_tpu_torch.models.heat import (
        assemble_heat_system,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import choose_operator
    from domain_decomposed_pde_solver_tpu_torch.solvers.precond.amg import (
        infer_free_grid,
    )

    mesh = box_mesh(*shape, elem_type=elem)
    sy = assemble_heat_system(mesh)
    dims = infer_free_grid(mesh, sy.free_to_node)
    return sy, choose_operator(sy.A, dtype=torch.float32, grid_dims=dims,
                               pad_stencil="always", device=device)


def _wide_dia(device, n=200_000, mx=97, my=89, seed=5):
    """Random DIA matrix on diagonals reaching +-(mx*my + mx + 1)."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.ops.csr import CSRMatrix
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import dia_from_csr

    rng = np.random.default_rng(seed)
    big = mx * my + mx + 1
    rows, cols = [], []
    for o in (-big, -mx * my - 1, -mx * my, -mx, -1, 0, 1, mx, mx * my,
              mx * my + 1, big):
        i = np.arange(max(0, -o), min(n, n - o))
        rows.append(i)
        cols.append(i + o)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    order = np.lexsort((cols, rows))
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows[order], minlength=n), out=indptr[1:])
    csr = CSRMatrix(indptr=indptr, indices=cols[order].astype(np.int64),
                    data=rng.normal(size=rows.size), shape=(n, n))
    import torch

    return {name: dia_from_csr(csr, dtype=getattr(torch, name), device=device)
            for name in ("float32", "float64")}


def compare_phase(device, run_a, run_b, run_c) -> dict:
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import bsg_spmv, spmv_plain
    from domain_decomposed_pde_solver_tpu_torch.ops.dia_kernel import (
        dia_matvec_plain,
    )

    rng = np.random.default_rng(0)
    errs = {}

    def pad_cases(label, A, sy):
        mask = A.pad_mask() == 0
        for name, tol in (("float32", TOL_F32), ("float64", TOL_F64)):
            x = A.put_vector(rng.normal(size=sy.n_free),
                             dtype=getattr(torch, name))
            _compare(f"pad-stencil {label} ({name} vectors)", A.matvec(x),
                     A.matvec_reference(x), tol, errs, "pad_stencil", mask)

    A1m = run_a["report"]["operator"]
    pad_cases(f"path A, dims {A1m.dims}, (Z, myp, mxp) = ({A1m.Z}, "
              f"{A1m.myp}, {A1m.mxp})", A1m, run_a["report"]["system"])
    for shape, elem in (((130, 12, 12), "TETRA4"), ((40, 40, 40), "HEX8")):
        sy, A = _pad_operator(shape, elem, device)
        pad_cases(f"box_mesh{shape} {elem} mxp={A.mxp} period={A.period}",
                  A, sy)

    def dia_case(label, A, name, tol):
        x = torch.as_tensor(rng.normal(size=A.n_pad), dtype=getattr(torch, name),
                            device=device)
        _compare(f"DIA {label} ({A.ndiags} diagonals, {A.n_pad} rows, "
                 f"{str(A.data.dtype)[6:]} storage)", A.matvec(x),
                 dia_matvec_plain(A, x), tol, errs, "dia_spmv")

    L1 = run_a["report"]["precond"].levels[1].A
    dia_case("level 1 of path A", L1, "float32", TOL_F32)
    dia_case("level 1 of path A", L1, "float64", TOL_F64)
    dia_case("fine operator of the default route", run_b["report"]["operator"],
             "float64", TOL_F64)
    wide = _wide_dia(device)
    dia_case("random, offsets +-(mx*my+mx+1)", wide["float32"], "float32",
             TOL_F32)
    dia_case("random, offsets +-(mx*my+mx+1)", wide["float64"], "float64",
             TOL_F64)

    solver = run_c["solver"]
    A, P0 = solver.operator, solver._precond.levels[0].P
    check(hasattr(P0, "G"), "[D] level 0 has no sliced-ELL transfers G/GT")

    def vec(n, dtype=np.float32):
        return torch.from_numpy(rng.normal(size=n).astype(dtype)).to(device)

    x32 = vec(A.n_pad)
    for label, op, x, tol in (
        ("fine A", A, x32, TOL_F32),
        ("fine A", A, x32.double(), TOL_F64),
        ("G", P0.G, vec(P0.G.x_len), TOL_F32),
        ("GT", P0.GT, vec(P0.GT.x_len), TOL_F32),
    ):
        _compare(f"sliced ELL {label} ({op.n_pad} rows, {op.n_slots} slots)",
                 bsg_spmv(op, x), spmv_plain(op, x), tol, errs, "sell_spmv")
    return errs


# ---------------------------------------------------------------------------
# E. Timing
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int = 50) -> float:
    """Milliseconds per call, CUDA events around ``reps`` back-to-back
    calls after a warm-up: device time plus any gap the host's dispatch
    leaves between calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_ms_cold(fn, scrub, reps: int = 20) -> float:
    """Milliseconds per call with the 50 MB L2 flushed before each call
    (a 256 MB buffer rewritten), CUDA events around each call alone."""
    import torch

    fn()
    total = 0.0
    for _ in range(reps):
        scrub.add_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def _device_events(prof):
    """(name, start_us, end_us) of every device-side event of a profile."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) == cuda:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for s, t in sorted(intervals):
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total


def profile_device(fn, reps: int = 20) -> dict:
    """torch.profiler (CUPTI) over ``reps`` calls after a warm-up: device
    time per call (the sum of its kernels, copies and fills), the union of
    its device intervals per call, the wall per call under the profiler,
    and device time by kernel name.  A trace with no device events at all
    (CUPTI now and then hands back an empty one) is taken again, up to
    three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = _device_events(prof)
        if ev:
            break
        log(f"profiler: trace {attempt + 1} recorded no device time")
    check(bool(ev), "the profiler recorded no device time")
    by_name = {}
    for name, s, t in ev:
        d = by_name.setdefault(name, [0, 0.0])
        d[0] += 1
        d[1] += (t - s) / 1e3 / reps
    return dict(
        device_ms=sum(t - s for _n, s, t in ev) / 1e3 / reps,
        busy_ms=_union_us([(s, t) for _n, s, t in ev]) / 1e3 / reps,
        wall_ms=wall * 1e3 / reps,
        kernels={k: (v[0] / reps, v[1]) for k, v in by_name.items()},
    )


def _measure(fns: dict, reps: int = 50) -> dict:
    """Per function: CUDA-event ms per call back to back, twice, in turns
    (a, b, c, c, b, a), and the profiler's device ms per call."""
    order = list(fns) + list(reversed(fns))
    events = {k: [] for k in fns}
    for k in order:
        events[k].append(time_ms(fns[k], reps))
    return {k: dict(events_ms=events[k],
                    device_ms=profile_device(fns[k])["device_ms"])
            for k in fns}


def _csr_tensor(indptr, indices, data, n_cols, dtype, device):
    import torch

    return torch.sparse_csr_tensor(
        torch.as_tensor(indptr, dtype=torch.int64),
        torch.as_tensor(indices, dtype=torch.int64),
        torch.as_tensor(data, dtype=dtype),
        size=(len(indptr) - 1, n_cols), check_invariants=False,
    ).to(device)


def _dia_csr(A):
    """Host CSR arrays of a DIA operator's logical rows (nonzeros only)."""
    import numpy as np
    import scipy.sparse as sp

    data = A.data.float().cpu().numpy().astype(np.float64)
    n = A.n_rows
    rows, cols, vals = [], [], []
    for d, off in enumerate(A.offsets):
        i = np.arange(n)
        keep = (data[d, :n] != 0) & (i + off >= 0) & (i + off < n)
        rows.append(i[keep])
        cols.append(i[keep] + off)
        vals.append(data[d, :n][keep])
    S = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    S.sort_indices()
    return S.indptr, S.indices, S.data


def timing_phase(device, card, run_a, run_b, run_c) -> dict:
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import bsg_spmv, spmv_plain
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import dia_from_csr
    from domain_decomposed_pde_solver_tpu_torch.ops.dia_kernel import (
        dia_matvec_plain,
    )

    rng = np.random.default_rng(1)
    rec = {}

    # Kernel 3, the 1M pad-stencil product (the main path's shape).
    A = run_a["report"]["operator"]
    sy = run_a["report"]["system"]
    S = sy.A.to_scipy()
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        x = A.put_vector(rng.normal(size=sy.n_free), dtype=dt)
        xi = A.extract_device(x).contiguous()
        Acsr = _csr_tensor(S.indptr, S.indices, S.data, S.shape[1], dt, device)
        t = _measure({
            "kernel": lambda: A.matvec(x),
            "plain": lambda: A.matvec_reference(x),
            "library": lambda: Acsr @ xi,
        })
        # Compulsory bytes: x and corr on the real nodes only (pad slots of
        # x hold 0 and corr is not needed there), y on every slot (pads are
        # written 0).
        vb = x.element_size()
        nbytes = (A.n_rows * (vb + A.corr.element_size())
                  + A.n_pad * vb)
        flops = A.n_rows * (len(A.taps) + 2 * len(A.groups) + 2)
        b_ms, b_by = bound(nbytes, flops)
        scrub = torch.empty(64 * 2**20, dtype=torch.float32, device=device)
        cold = time_ms_cold(lambda: A.matvec(x), scrub)
        del scrub
        log(f"[E] pad-stencil 1M ({name} vectors, {A.n_pad} slots), device "
            f"ms per call: kernel {t['kernel']['device_ms']}, plain "
            f"{t['plain']['device_ms']}, cuSPARSE CSR ({S.nnz} nnz) "
            f"{t['library']['device_ms']}; events back to back: "
            f"{json.dumps({k: v['events_ms'] for k, v in t.items()})}; kernel "
            f"alone with L2 flushed {cold} ms; bound {b_ms} ms by {b_by} "
            f"({nbytes / 1e6:.2f} MB) [{card}]")
        rec[f"pad_stencil/{name}"] = dict(
            ms=t["kernel"]["device_ms"], plain_ms=t["plain"]["device_ms"],
            library_ms=t["library"]["device_ms"], bound_ms=b_ms,
            bound_by=b_by, cold_ms=cold,
            events_ms={k: v["events_ms"] for k, v in t.items()})
        del Acsr

    # Kernel 4: level 1 of the 1M hierarchy (the main path's shape), then
    # the default route's f64/bf16 fine DIA at the 1M size.
    L1 = run_a["report"]["precond"].levels[1].A
    fine = dia_from_csr(sy.A, dtype=torch.float64, device=device)
    for label, D, name in (("level 1", L1, "float32"),
                           ("1M fine", fine, "float64")):
        dt = getattr(torch, name)
        x = torch.as_tensor(rng.normal(size=D.n_pad), dtype=dt, device=device)
        ip, ix, dv = _dia_csr(D)
        Dcsr = _csr_tensor(ip, ix, dv, D.n_rows, dt, device)
        xr = x[: D.n_rows].contiguous()
        t = _measure({
            "kernel": lambda: D.matvec(x),
            "plain": lambda: dia_matvec_plain(D, x),
            "library": lambda: Dcsr @ xr,
        })
        vb = x.element_size()
        nbytes = D.ndiags * D.n_pad * D.data.element_size() + 2 * D.n_pad * vb
        b_ms, b_by = bound(nbytes, 2 * D.ndiags * D.n_pad)
        log(f"[E] DIA {label} ({D.ndiags} diagonals, {D.n_pad} rows, "
            f"{str(D.data.dtype)[6:]} storage, {name} vectors), device ms "
            f"per call: kernel {t['kernel']['device_ms']}, plain "
            f"{t['plain']['device_ms']}, cuSPARSE CSR "
            f"{t['library']['device_ms']}; events back to back: "
            f"{json.dumps({k: v['events_ms'] for k, v in t.items()})}; bound "
            f"{b_ms} ms by {b_by} [{card}]")
        rec[f"dia_spmv/{label}"] = dict(
            ms=t["kernel"]["device_ms"], plain_ms=t["plain"]["device_ms"],
            library_ms=t["library"]["device_ms"], bound_ms=b_ms,
            bound_by=b_by,
            events_ms={k: v["events_ms"] for k, v in t.items()})
    del fine

    # Kernel 1: slice 1's fine operator.
    solver = run_c["solver"]
    Af = solver.operator
    csr = solver.system.A
    x = torch.from_numpy(rng.normal(size=Af.n_pad).astype(np.float32)).to(device)
    perm = Af.perm
    xo = x[perm].contiguous()  # original order: the same product
    Acsr = _csr_tensor(csr.indptr, csr.indices, csr.data, csr.n_cols,
                       torch.float32, device)
    t = _measure({
        "kernel": lambda: bsg_spmv(Af, x),
        "plain": lambda: spmv_plain(Af, x),
        "library": lambda: Acsr @ xo,
    })
    nbytes = (Af.n_slots * 8 + Af.slice_ptr.numel() * 8 + Af.x_len * 4
              + Af.n_pad * 4)
    b_ms, b_by = bound(nbytes, 2 * Af.n_slots)
    log(f"[E] sliced ELL fine ({Af.n_pad} rows, {Af.n_slots} slots, f32), "
        f"device ms per call: kernel {t['kernel']['device_ms']}, plain "
        f"{t['plain']['device_ms']}, cuSPARSE CSR ({csr.nnz} nnz) "
        f"{t['library']['device_ms']}; events back to back: "
        f"{json.dumps({k: v['events_ms'] for k, v in t.items()})}; bound "
        f"{b_ms} ms by {b_by} [{card}]")
    rec["sell_spmv"] = dict(
        ms=t["kernel"]["device_ms"], plain_ms=t["plain"]["device_ms"],
        library_ms=t["library"]["device_ms"], bound_ms=b_ms, bound_by=b_by,
        events_ms={k: v["events_ms"] for k, v in t.items()})
    rec["solve_a_warm"] = warm_solve_breakdown(card, run_a)
    return rec


def warm_solve_breakdown(card, run_a) -> dict:
    """Path A's refinement solve again, warm (operator and hierarchy
    reused, same x0): wall of three runs, then one run under the profiler
    for device busy time, idle share and device time by kernel."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.solvers.mixed import (
        iterative_refinement_solve,
    )

    rep = run_a["report"]
    sy, A, M = rep["system"], rep["operator"], rep["precond"]
    x0 = np.random.default_rng(0).uniform(-1.0, 1.0, size=sy.n_free)

    def solve():
        return iterative_refinement_solve(sy.A, sy.b, x0=x0, tol=1e-8,
                                          inner_maxiter=300, precond=M,
                                          operator=A)

    walls, results = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        results.append(solve())
        walls.append((time.perf_counter() - t0) * 1e3)
    prof = profile_device(solve, reps=1)
    top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1][1])[:12]
    idle = 1.0 - prof["busy_ms"] / prof["wall_ms"]
    log(f"[E] warm 1e-8 solve, path A: wall {walls} ms; sweeps "
        f"{[r.refinements for r in results]}, inner "
        f"{[r.inner_iterations for r in results]}, timings "
        f"{json.dumps(results[-1].timings)}; under the profiler wall "
        f"{prof['wall_ms']} ms, device busy {prof['busy_ms']} ms (idle "
        f"share {idle}), device sum {prof['device_ms']} ms [{card}]")
    for name, (count, ms) in top:
        log(f"[E]   {ms:.4f} ms in {count:g} x {name[:110]}")
    return dict(wall_ms=walls, timings=results[-1].timings,
                profiled_wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"],
                idle_share=idle, device_ms=prof["device_ms"],
                top=[(n[:110], c, m) for n, (c, m) in top])


def main() -> int:
    import torch

    # ---- 1. the card ----------------------------------------------------
    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available")
    check((REPO / "domain_decomposed_pde_solver_tpu_torch").is_dir(),
          "run from a checkout of the repository")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    device = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
    from domain_decomposed_pde_solver_tpu_torch.utils.native import native_available

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    kernels = _kernels.build_kernels()
    log(f"build: {time.perf_counter() - t0:.2f} s into "
        f"{_kernels.kernel_build_dir()}")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "ptxas info" in line and "Used" in line:
                log(f"  {k.name}: {line.strip()}")
    check(native_available(), "native host library did not build")

    # ---- A-C. the paths -------------------------------------------------
    run_a = phase_a(kernels)
    log(f"[A] done at {time.perf_counter() - t_start:.1f} s")
    run_b = phase_b(kernels)
    run_c = phase_c(device, kernels)
    log(f"[C] done at {time.perf_counter() - t_start:.1f} s")

    # ---- D. kernels against plain versions (launches not counted) --------
    errs = compare_phase(device, run_a, run_b, run_c)

    # ---- E. timing and records --------------------------------------------
    rec = timing_phase(device, card, run_a, run_b, run_c)
    res1, res2 = run_c["res"]
    mr = run_a["report"]["mixed"]
    log("smoke: " + json.dumps({
        "card": card,
        "structured": {
            "dof": run_a["report"]["system"].n_free,
            "levels": run_a["levels"],
            "sweeps": mr.refinements,
            "inner_iterations": mr.inner_iterations,
            "relres": mr.relres,
            "host_relres": run_a["host_relres"],
            "timings_ms": mr.timings,
            "phases_s": run_a["report"]["timer"].as_dict(),
            "cli_wall_s": run_a["wall"],
            "launches": run_a["counts"],
        },
        "unstructured": {
            "dof": run_c["solver"].system.n_free,
            "setup_s": run_c["t_setup"],
            "solve_ms": [t * 1e3 for t in run_c["t_solve"]],
            "iterations": [res1.iterations, res2.iterations],
            "host_relres": list(run_c["host_relres"]),
            "launches": run_c["counts"],
        },
        "timing": rec,
        "total_s": time.perf_counter() - t_start,
    }))
    main_shape = {"sell_spmv": ("sell_spmv", run_c["counts"]),
                  "pad_stencil": ("pad_stencil/float32", run_a["counts"]),
                  "dia_spmv": ("dia_spmv/level 1", run_a["counts"])}
    records = []
    for k in kernels:
        key, counts = main_shape[k.name]
        r = rec[key]
        records.append({
            "name": k.name,
            "route": "cuda",
            "source": str(k.src.relative_to(REPO)),
            "replaces": REPLACES[k.name],
            "launches": counts[k.name]["launches"],
            "max_abs_err": errs[k.name],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
