#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``domain_decomposed_pde_solver_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; no phase catches an
error and carries on):

1. Require CUDA; print the card's name and power limit from ``nvidia-smi``.
2. Build every kernel of the port from ``csrc/`` into ``build/kernels/``.
3. Drive the main path with every kernel launch counter at 0: build the
   833,048-DOF refined tet box (``refine_uniform(box_mesh(49, 49, 49,
   "TETRA4"), 1)``), construct ``SteadyHeatSolver(mesh, dtype=float32,
   precond="amg", device="cuda")`` and solve twice (reference boundary
   values, then a warm solve with ``bc={100: 80.0, 1000: 25.0}``); read the
   counters.
4. Hold the SpMV kernel against its plain PyTorch version on the card, on
   the operators the main path built: the square fine operator with f32 and
   f64 vectors, the rectangular tentative transfer ``G`` (one entry per
   row) and ``GT`` (ragged rows, input length != output rows), and a matrix
   with empty rows (f32 and f64 storage).  Relative error limit: 1e-5 in
   f32, 1e-12 in f64 (summation order: the plain version adds the same
   products in the same order, but without fused multiply-adds).  The
   comparison runs after the main path so that its launches do not count.
5. Check the answers: converged, host f64 residual ||b - A u|| / ||b|| <=
   2e-6 (the warm f32 solve: 2e-6 plus its f32 rounding floor, see
   ``check_answers``), every value inside the boundary values (maximum
   principle); write the first solution as Exodus, read it back and check
   it.
6. Time one SpMV on the fine operator, kernel and plain version, with CUDA
   events; print the kernel record, then the device record as the last line.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
MESH_CELLS = 49  # refine_uniform(box_mesh(49, 49, 49)) -> 833,048 free DOF
TOL_F32 = 1e-5
TOL_F64 = 1e-12
BC2 = {100: 80.0, 1000: 25.0}


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


def rel_err(y, y_ref) -> tuple:
    import torch

    diff = (y.double() - y_ref.double()).abs().max().item()
    scale = max(y_ref.double().abs().max().item(), 1e-300)
    check(bool(torch.isfinite(y).all()), "kernel output is not finite")
    return diff, diff / scale


def compare(name: str, A, x, tol: float, device) -> float:
    """Kernel against plain version on the same operator and input;
    returns the largest absolute difference."""
    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import bsg_spmv, spmv_plain

    y = bsg_spmv(A, x)
    y_ref = spmv_plain(A, x)
    sync(device)
    check(tuple(y.shape) == tuple(y_ref.shape) == (A.n_pad,),
          f"{name}: shape {tuple(y.shape)}")
    abs_err, rel = rel_err(y, y_ref)
    log(f"compare {name}: rows={A.n_pad} x_len={x.numel()} slots={A.n_slots} "
        f"storage={A.storage} x={str(x.dtype)[6:]} max_rel_err={rel:.3e} "
        f"(limit {tol:.0e})")
    check(rel <= tol, f"{name}: kernel disagrees with plain ({rel:.3e} > {tol})")
    return abs_err


def empty_rows_operator(device, storage: str, seed: int = 0):
    """Rectangular random matrix with runs of empty rows (incl. whole
    slices) and a short input."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import bsg_from_coo

    rng = np.random.default_rng(seed)
    n_rows, x_len = 5000, 3001
    live = rng.random(n_rows) < 0.6
    live[1000:1100] = False  # >= 3 whole empty slices
    rows = np.repeat(np.flatnonzero(live), rng.integers(1, 40, live.sum()))
    cols = rng.integers(0, x_len, rows.size)
    vals = rng.normal(size=rows.size)
    return bsg_from_coo(rows, cols, vals, n_rows, x_len, storage=storage,
                        device=device)


def time_spmv(fn, A, x, reps: int = 50) -> float:
    """Milliseconds per call, CUDA events around ``reps`` calls."""
    import torch

    for _ in range(3):
        fn(A, x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(A, x)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_relres(system, u, b) -> float:
    import numpy as np

    r = b - system.A.matvec(np.asarray(u, dtype=np.float64))
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive_main_path(device, cells: int, kernels) -> dict:
    """Phase 3: mesh, solver, two solves, with the launch counters from 0."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch import SteadyHeatSolver
    from domain_decomposed_pde_solver_tpu_torch.io import box_mesh, refine_uniform

    t0 = time.perf_counter()
    mesh = refine_uniform(box_mesh(cells, cells, cells, "TETRA4"), 1)
    t_mesh = time.perf_counter() - t0
    for k in kernels:
        k.launches = 0
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
    launches = {k.name: k.launches for k in kernels}

    sys_, M = solver.system, solver._precond
    log(f"mesh: {mesh.num_nodes} nodes, {sys_.n_free} free DOF, "
        f"{sys_.A.nnz} nnz, {t_mesh:.2f} s")
    log(f"levels: {[lvl.n_rows for lvl in M.levels]} + coarse "
        f"{tuple(M.coarse_inv.shape)}; level ops "
        f"{[type(lvl.A).__name__ for lvl in M.levels]}, transfers "
        f"{[type(lvl.P).__name__ for lvl in M.levels]}")
    log(f"setup (assembly + operator + AMG): {t_setup:.3f} s")
    log(f"solve 1: {res1.iterations} iters, relres {res1.relres:.3e}, "
        f"{t_solve1 * 1e3:.1f} ms")
    log(f"solve 2 (warm, bc {BC2}): {res2.iterations} iters, relres "
        f"{res2.relres:.3e}, {t_solve2 * 1e3:.1f} ms")
    log(f"launches during the main path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")
    return dict(mesh=mesh, solver=solver, u=(u1, u2), res=(res1, res2),
                launches=launches, t_mesh=t_mesh, t_setup=t_setup,
                t_solve=(t_solve1, t_solve2))


def compare_phase(run: dict, device) -> float:
    """Phase 4: kernel against plain version on the main path's operators;
    returns the largest absolute difference."""
    import numpy as np
    import torch

    solver = run["solver"]
    A, P0 = solver.operator, solver._precond.levels[0].P
    check(hasattr(P0, "G"), "level 0 has no sliced-ELL transfers G/GT")
    rng = np.random.default_rng(0)

    def vec(n, dtype=np.float32):
        return torch.from_numpy(rng.normal(size=n).astype(dtype)).to(device)

    x32 = vec(A.n_pad)
    errs = [
        compare("fine A (f32)", A, x32, TOL_F32, device),
        compare("fine A (f64 vectors)", A, x32.double(), TOL_F64, device),
        compare("G (f32)", P0.G, vec(P0.G.x_len), TOL_F32, device),
        compare("GT (f32)", P0.GT, vec(P0.GT.x_len), TOL_F32, device),
    ]
    for storage, tol, dt in (("float32", TOL_F32, np.float32),
                             ("float64", TOL_F64, np.float64)):
        E = empty_rows_operator(device, storage)
        xe = vec(E.x_len - 7, dt)  # shorter input: zero-extended
        errs.append(compare(f"empty rows ({storage})", E, xe, tol, device))
        y = E.matvec(xe).cpu().numpy()
        live = E.slot_row().cpu().numpy()[E.vals.cpu().numpy() != 0]
        empty = np.ones(E.n_pad, bool)
        empty[live] = False
        check(bool(np.all(y[empty] == 0)), "empty / padding rows are not 0")
    return max(errs)


def check_answers(run: dict) -> tuple:
    """Phase 5: convergence, host residual, maximum principle, file."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.io import read_nodal_vars

    solver, mesh = run["solver"], run["mesh"]
    sys_ = solver.system
    (u1, u2), (res1, res2) = run["u"], run["res"]
    b1, b2 = solver.rhs_for(None), solver.rhs_for(BC2)
    rr = (host_relres(sys_, u1, b1), host_relres(sys_, u2, b2))
    # The warm solve starts from u1, ten times the scale of u2: its f32
    # updates round at that scale, and the recursive residual never sees
    # it, so its true residual cannot fall below the f32 rounding floor
    # eps * || |A| |u1| || / ||b2||.  Only an f64 residual (iterative
    # refinement) removes that floor.
    absA = abs(sys_.A.to_scipy())
    floor = float(np.finfo(np.float32).eps / 2 * np.linalg.norm(
        absA @ np.abs(u1.astype(np.float64))) / np.linalg.norm(b2))
    limits = (2e-6, 2e-6 + floor)
    log(f"host f64 relres: solve 1 {rr[0]:.3e} (limit {limits[0]:.1e}), "
        f"solve 2 {rr[1]:.3e} (limit {limits[1]:.3e}: 2e-6 + f32 "
        f"warm-start floor {floor:.3e})")
    for i, (res, u, r, lim, lo, hi) in enumerate(
        ((res1, u1, rr[0], limits[0], 100.0, 1000.0),
         (res2, u2, rr[1], limits[1], 25.0, 80.0)), 1
    ):
        check(res.converged, f"solve {i} did not converge")
        check(u.shape == (sys_.n_free,), f"solve {i}: shape {u.shape}")
        check(bool(np.isfinite(u).all()), f"solve {i}: non-finite values")
        check(r <= lim, f"solve {i}: host relres {r:.3e} > {lim:.3e}")
        check(lo <= float(u.min()) and float(u.max()) <= hi,
              f"solve {i}: values [{u.min()}, {u.max()}] outside [{lo}, {hi}]")
    out_dir = REPO / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "solution.exo"
    solver.write_solution(str(path), u1)
    _names, times, vals = read_nodal_vars(str(path))
    check(vals.shape == (2, 1, mesh.num_nodes), f"read back {vals.shape}")
    bnd = solver.boundary_values_for(None)
    check(np.array_equal(vals[0, 0], bnd), "timestep 0 is not the boundary snapshot")
    free = sys_.free_to_node
    check(np.array_equal(vals[1, 0, free], u1.astype(np.float64)),
          "timestep 1 does not hold the solution")
    fixed = np.ones(mesh.num_nodes, bool)
    fixed[free] = False
    check(np.array_equal(vals[1, 0, fixed], bnd[fixed]),
          "boundary values changed in the solution step")
    log(f"solution file: {path.name}, {len(times)} timesteps, read back OK")
    return rr, floor


def main() -> int:
    import numpy as np
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

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import bsg_spmv, spmv_plain
    from domain_decomposed_pde_solver_tpu_torch.utils.native import native_available

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    kernels = _kernels.build_kernels()
    log(f"build: {time.perf_counter() - t0:.2f} s into "
        f"{_kernels.kernel_build_dir()}")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "ptxas info" in line and "Used" in line:
                log(f"  {line.strip()}")
    check(native_available(), "native host library did not build")

    # ---- 3-5. main path, kernel against plain, answers ------------------
    run = drive_main_path(device, MESH_CELLS, kernels)
    n_free = run["solver"].system.n_free
    check(n_free == 833_048, f"expected 833048 free DOF, got {n_free}")
    max_abs_err = compare_phase(run, device)
    rr, floor = check_answers(run)

    # ---- 6. timing and records ------------------------------------------
    A = run["solver"].operator
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=A.n_pad).astype(np.float32)).to(device)
    ms = time_spmv(bsg_spmv, A, x)
    plain_ms = time_spmv(spmv_plain, A, x)
    ms2 = time_spmv(bsg_spmv, A, x)
    plain_ms2 = time_spmv(spmv_plain, A, x)
    log(f"fine SpMV (f32, {A.n_pad} rows, {A.n_slots} slots): kernel "
        f"{ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.4f} / {plain_ms2:.4f} ms "
        f"[{card}]")
    res1, res2 = run["res"]
    log("smoke: " + json.dumps({
        "card": card,
        "dof": n_free,
        "nnz": int(run["solver"].system.A.nnz),
        "levels": [lvl.n_rows for lvl in run["solver"]._precond.levels],
        "mesh_s": run["t_mesh"],
        "setup_s": run["t_setup"],
        "solve_ms": [t * 1e3 for t in run["t_solve"]],
        "iterations": [res1.iterations, res2.iterations],
        "relres": [res1.relres, res2.relres],
        "host_relres": list(rr),
        "warm_f32_floor": floor,
        "spmv_ms": [ms, ms2],
        "plain_spmv_ms": [plain_ms, plain_ms2],
    }))
    print(json.dumps({"kernels": [{
        "name": k.name,
        "route": "cuda",
        "source": str(k.src.relative_to(REPO)),
        "replaces": "domain_decomposed_pde_solver_tpu/ops/bsg.py:822",
        "launches": run["launches"][k.name],
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    } for k in kernels]}))
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
