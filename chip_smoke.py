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
D1. Jacobi-PCG in one launch (the fused CG kernel) against the unfused
   ``cg_solve`` with the Jacobi preconditioner on the sliced-ELL kernel, on
   path C's 833,048-DOF operator and on the 16,028-DOF
   ``refine_uniform(box_mesh(13, 13, 13, "TETRA4"), 1)`` (the size of the
   reference's tet-cube-heat, L2-resident), f32 to 1e-6: both converge,
   iterations within max(2, 2 %), host f64 relres <= 5e-6 plus the f32
   rounding floor eps/2 * || |A| |u| || / ||b|| (hundreds of f32 updates
   at the answer's scale), with u a host f64 Jacobi-PCG answer to 1e-10
   computed before either solve, exactly one fused launch and no
   sliced-ELL launch inside a fused solve.
D2. The same 833k system packed ``layout="ragged", chunk=16`` (the chunked
   kernel), which stores exactly the dense layout's slots: Jacobi-PCG, and
   CG+AMG with the ragged operator as the AMG's fine level, each within
   one iteration of the dense layout's; the chunked kernel launched, the
   sliced-ELL kernel only by the coarser levels and the transfers.
D3. The CLI's reference routes on an unstructured mesh written to Exodus,
   in f64 to 1e-8: ``--solver bicgstab --precond jacobi`` and
   ``--solver cg --precond chebyshev`` on
   ``refine_uniform(box_mesh(25, 25, 25, "TETRA4"), 1)`` (111,824 DOF),
   ``--solver gmres --precond ilut`` (the reference's configuration) on
   the 16,028-DOF mesh: the host ILUT factorization grows about as n^2.1
   on this numbering (its working row fills to the bandwidth), some 30 min
   at 111,824 DOF.  Each exits 0 with a host relres from the file <= 1.5e-8
   and values in [100, 1000].
D. Every kernel against its plain PyTorch version on the card, on the
   paths' operators and a few more shapes (relative error limit 1e-5 in
   f32, 1e-12 in f64: the same products summed in another order, with
   fused multiply-adds; the fused CG solve within 2 iterations and 1e-4 of
   its plain recurrence; the chunked kernel also bit-identical over two
   launches).  These launches do not count.
E. Times with CUDA events and the profiler: each kernel on its path's
   shape, its plain version and, as a yardstick the port never calls, one
   PyTorch call computing the same product (cuSPARSE through
   ``torch.sparse_csr_tensor @ x``); the pad-stencil product also with L2
   flushed between calls, at every z-depth of ``PAD_DEPTHS`` (each
   bit-identical to the launch's own choice) and on a 10M-DOF space of
   the same stencil (mxp = 256); the fused CG solve against the unfused
   loop (no single PyTorch call solves CG).  Print the kernel record, the
   card line and the device record as the last line.
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
SMALL_CELLS = 13  # refine_uniform(box_mesh(13, 13, 13)) -> 16,028 free DOF
CLI_CELLS = 25  # refine_uniform(box_mesh(25, 25, 25)) -> 111,824 free DOF
PCG_TOL, PCG_MAXITER = 1e-6, 5000
VECTOR_PASSES = 9  # fused CG: write Ap; read+write x, r, p; read D^-1, Ap
TOL_F32 = 1e-5
TOL_F64 = 1e-12
BC2 = {100: 80.0, 1000: 25.0}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet, at 700 W
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
REPLACES = {
    "sell_spmv": "domain_decomposed_pde_solver_tpu/ops/bsg.py:822",
    "pad_stencil": "domain_decomposed_pde_solver_tpu/ops/pallas/stencil_kernel.py:421",
    "dia_spmv": "domain_decomposed_pde_solver_tpu/ops/pallas/dia_kernel.py:45",
    "sell_chunked_spmv": "domain_decomposed_pde_solver_tpu/ops/bsg.py:857",
    "fused_cg": "domain_decomposed_pde_solver_tpu/solvers/fused_cg.py:34",
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


def launch_delta(kernels, fn):
    """Run ``fn`` (then synchronise); returns its result and the launches
    of every kernel during it."""
    import torch

    before = {k.name: k.launches for k in kernels}
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {k.name: k.launches - before[k.name] for k in kernels}


def host_relres(A, u, b) -> float:
    import numpy as np

    r = b - A.matvec(np.asarray(u, dtype=np.float64))
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def f32_floor(A, u, b) -> float:
    """The f32 rounding floor of a host relative residual:
    eps/2 * || |A| |u| || / ||b||, what one rounding of every product of
    an f32 update at the answer's scale leaves, which the recursive
    residual of an f32 Krylov solve never sees."""
    import numpy as np

    absA = abs(A.to_scipy())
    return float(np.finfo(np.float32).eps / 2 * np.linalg.norm(
        absA @ np.abs(np.asarray(u, dtype=np.float64))) / np.linalg.norm(b))


def host_cg_f64(A, b, tol: float = 1e-10, maxiter: int = 20000):
    """Jacobi-PCG in float64 on the host (SciPy's CSR product): an answer
    independent of the solvers under test."""
    import numpy as np

    S = A.to_scipy().tocsr()
    d = S.diagonal()
    invd = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    b = np.asarray(b, dtype=np.float64)
    x = np.zeros_like(b)
    r = b.copy()
    p = invd * r
    rz = r @ p
    target = tol * np.linalg.norm(b)
    k = 0
    while np.linalg.norm(r) > target and k < maxiter:
        ap = S @ p
        alpha = rz / (p @ ap)
        x += alpha * p
        r -= alpha * ap
        z = invd * r
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    check(np.linalg.norm(r) <= target, "host f64 reference did not converge")
    return x, k


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
    floor = f32_floor(sys_.A, u1, b2)
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
# D1-D3. Kernels 5 and 2 on their paths; the CLI's reference routes
# ---------------------------------------------------------------------------


def _refined_system(cells: int, device):
    from domain_decomposed_pde_solver_tpu_torch.io import box_mesh, refine_uniform
    from domain_decomposed_pde_solver_tpu_torch.models.heat import (
        assemble_heat_system,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import bsg_from_csr

    sy = assemble_heat_system(refine_uniform(box_mesh(cells, cells, cells,
                                                      "TETRA4"), 1))
    return sy, bsg_from_csr(sy.A, device=device)


def phase_d1(device, kernels, run_c, small_cells: int = SMALL_CELLS) -> dict:
    """Fused Jacobi-PCG against the unfused loop at 833k and 16k DOF."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch.solvers import (
        cg_solve,
        fused_cg_solve,
        jacobi_preconditioner,
    )

    solver = run_c["solver"]
    sy_s, A_s = _refined_system(small_cells, device)
    cases = {"833k": (solver.system, solver.operator), "16k": (sy_s, A_s)}
    reset_counts(kernels)
    out = {}
    for label, (sy, A) in cases.items():
        # Hundreds of f32 updates at the answer's scale: the true residual
        # may sit above the recursive one by a few rounding floors.  The
        # floor is taken from an independent f64 answer.
        t0 = time.perf_counter()
        u_ref, k_ref = host_cg_f64(sy.A, sy.b)
        t_ref = time.perf_counter() - t0
        floor = f32_floor(sy.A, u_ref, sy.b)
        limit = 5e-6 + floor
        b = A.put_vector(sy.b, dtype=torch.float32)
        M = jacobi_preconditioner(A)
        t0 = time.perf_counter()
        ru, du = launch_delta(kernels, lambda: cg_solve(
            A, b, torch.zeros_like(b), precond=M, tol=PCG_TOL,
            maxiter=PCG_MAXITER))
        wall_u = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rf, df = launch_delta(kernels, lambda: fused_cg_solve(
            A, b, tol=PCG_TOL, maxiter=PCG_MAXITER))
        wall_f = (time.perf_counter() - t0) * 1e3
        rr = [host_relres(sy.A, A.get_vector(r.x), sy.b) for r in (ru, rf)]
        slack = max(2, int(0.02 * ru.iterations))
        log(f"[D1] {label} ({sy.n_free} DOF, {A.n_slots} slots): unfused "
            f"{ru.iterations} iterations in {wall_u:.1f} ms (launches "
            f"{json.dumps(du)}), fused {rf.iterations} in {wall_f:.1f} ms "
            f"(launches {json.dumps(df)}); host f64 relres {rr[0]:.3e} / "
            f"{rr[1]:.3e} (limit {limit:.3e}: 5e-6 + the f32 floor "
            f"{floor:.3e} of the host f64 answer, {k_ref} iterations to "
            f"1e-10 in {t_ref:.1f} s)")
        check(ru.converged and rf.converged, f"[D1] {label}: not converged")
        check(abs(rf.iterations - ru.iterations) <= slack,
              f"[D1] {label}: iterations {rf.iterations} vs {ru.iterations}")
        check(max(rr) <= limit, f"[D1] {label}: host relres {rr}")
        if device.type == "cuda":
            check(df["fused_cg"] == 1 and df["sell_spmv"] == 0,
                  f"[D1] {label}: launches in the fused solve {df}")
            check(du["sell_spmv"] > 0 and du["fused_cg"] == 0,
                  f"[D1] {label}: launches in the unfused solve {du}")
        out[label] = dict(system=sy, A=A, b=b, M=M, unfused=ru, fused=rf,
                          wall_ms=(wall_u, wall_f), host_relres=rr,
                          floor=floor, limit=limit)
    out["counts"] = read_counts(kernels)
    log(f"[D1] launches during the path: {json.dumps(out['counts'])}")
    return out


def phase_d2(device, kernels, run_c, run_d1) -> dict:
    """The 833k operator in the ragged layout: Jacobi-PCG and CG+AMG on
    the chunked kernel against the dense layout."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import (
        WARP_CHUNKS,
        bsg_from_csr,
    )
    from domain_decomposed_pde_solver_tpu_torch.solvers import (
        cg_solve,
        jacobi_preconditioner,
        smoothed_aggregation_setup,
    )

    solver = run_c["solver"]
    sy, A = solver.system, solver.operator
    t0 = time.perf_counter()
    R = bsg_from_csr(sy.A, layout="ragged", chunk=16, device=device)
    t_pack = time.perf_counter() - t0
    check(R.layout == "ragged" and torch.equal(R.perm, A.perm),
          "[D2] the ragged operator has another numbering")
    check(R.n_slots == A.n_slots,
          f"[D2] {R.n_slots} ragged slots, {A.n_slots} dense: the ragged "
          f"layout stores the dense layout's slots")
    b = R.put_vector(sy.b, dtype=torch.float32)
    zero = torch.zeros_like(b)
    reset_counts(kernels)
    rj, dj = launch_delta(kernels, lambda: cg_solve(
        R, b, zero, precond=jacobi_preconditioner(R), tol=PCG_TOL,
        maxiter=PCG_MAXITER))
    t0 = time.perf_counter()
    M_r = smoothed_aggregation_setup(sy.A, dtype=torch.float32,
                                     fine_operator=R, device=device)
    t_amg = time.perf_counter() - t0
    ra, da = launch_delta(kernels, lambda: cg_solve(
        R, b, zero, precond=M_r, tol=PCG_TOL, maxiter=200))
    rd, dd = launch_delta(kernels, lambda: cg_solve(
        A, b, zero, precond=solver._precond, tol=PCG_TOL, maxiter=200))
    counts = read_counts(kernels)
    ref_jacobi = run_d1["833k"]["unfused"]
    rr = [host_relres(sy.A, R.get_vector(r.x), sy.b) for r in (rj, ra)]
    log(f"[D2] ragged chunk 16: {R.n_chunks} chunks ({R.wide.numel()} in "
        f"slices of more than {WARP_CHUNKS} chunks), {R.n_slots} slots "
        f"(dense {A.n_slots}, slot ratio {R.n_slots / A.n_slots:.4f}), "
        f"packed in {t_pack:.2f} s, AMG set-up {t_amg:.2f} s")
    log(f"[D2] Jacobi-PCG {rj.iterations} iterations (dense "
        f"{ref_jacobi.iterations}), launches {json.dumps(dj)}; CG+AMG "
        f"{ra.iterations} (dense {rd.iterations}), launches ragged "
        f"{json.dumps(da)}, dense {json.dumps(dd)}; host f64 relres "
        f"{rr[0]:.3e} / {rr[1]:.3e}")
    check(rj.converged and ra.converged, "[D2] a ragged solve did not converge")
    check(abs(rj.iterations - ref_jacobi.iterations) <= 1,
          "[D2] Jacobi-PCG iterations differ by more than 1")
    check(abs(ra.iterations - rd.iterations) <= 1,
          "[D2] CG+AMG iterations differ by more than 1")
    check(rr[0] <= run_d1["833k"]["limit"] and rr[1] <= 2e-6,
          f"[D2] host relres {rr}")
    if device.type == "cuda":
        check(dj["sell_chunked_spmv"] > 0 and dj["sell_spmv"] == 0,
              f"[D2] Jacobi-PCG launches {dj}")
        check(da["sell_chunked_spmv"] > 0, "[D2] chunked kernel not launched")
        # Only level 0 moved to the chunked kernel: at equal iterations the
        # launches add up to the dense run's.
        if ra.iterations == rd.iterations:
            check(da["sell_spmv"] + da["sell_chunked_spmv"] == dd["sell_spmv"],
                  f"[D2] launches ragged {da} vs dense {dd}")
        else:
            check(da["sell_spmv"] < dd["sell_spmv"], f"[D2] {da} vs {dd}")
    return dict(R=R, counts=counts, jacobi=rj, amg=ra, amg_dense=rd,
                host_relres=rr, t_pack=t_pack, t_amg=t_amg,
                launches=dict(jacobi=dj, amg=da, amg_dense=dd))


D3_ROUTES = (
    ("gmres-ilut", SMALL_CELLS, ["--solver", "gmres", "--precond", "ilut",
                                 "--iterations", "1000"]),
    ("bicgstab-jacobi", CLI_CELLS, ["--solver", "bicgstab", "--precond",
                                    "jacobi", "--iterations", "5000"]),
    ("cg-chebyshev", CLI_CELLS, ["--solver", "cg", "--precond", "chebyshev",
                                 "--iterations", "5000", "--no-snapshots"]),
)


def phase_d3(device, kernels, routes=D3_ROUTES, extra_args=()) -> dict:
    """The CLI's reference routes on unstructured meshes, f64 to 1e-8."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.io import (
        box_mesh,
        read_nodal_vars,
        refine_uniform,
        write_exodus,
    )

    OUT.mkdir(parents=True, exist_ok=True)
    paths = {}
    for cells in sorted({c for _n, c, _a in routes}):
        paths[cells] = OUT / f"refined{cells}.exo"
        write_exodus(str(paths[cells]),
                     refine_uniform(box_mesh(cells, cells, cells, "TETRA4"), 1))
    out = {}
    for name, cells, args in routes:
        sol = OUT / f"refined{cells}_{name}.exo"
        rep = {}
        rc, wall, counts = run_cli(
            ["--input", paths[cells], "--solution", sol, "--dtype", "float64",
             "--tolerance", "1e-8", *args, *extra_args], rep, kernels)
        check(rc == 0, f"[D3] {name}: the CLI exited with {rc}")
        sy, res, M = rep["system"], rep["result"], rep["precond"]
        _n, times, vals = read_nodal_vars(str(sol))
        rr = host_relres(sy.A, vals[-1, 0, sy.free_to_node], sy.b)
        levels = ((M.l_nlev, M.u_nlev) if hasattr(M, "l_nlev") else None)
        phases = rep["timer"].as_dict()
        log(f"[D3] {name} on refined box_mesh({cells}^3), {sy.n_free} DOF, "
            f"operator {type(rep['operator']).__name__}: {res.iterations} "
            f"iterations, {len(times)} timesteps, host relres {rr:.3e} (limit "
            f"1.5e-8), CLI wall {wall:.2f} s, phases {json.dumps(phases)}, "
            f"ILU levels (L, U) {levels}, launches {json.dumps(counts)}")
        check(rr <= 1.5e-8, f"[D3] {name}: host relres {rr:.3e} > 1.5e-8")
        check(bool(np.isfinite(vals).all()), f"[D3] {name}: non-finite values")
        check(100.0 <= float(vals[-1, 0].min())
              and float(vals[-1, 0].max()) <= 1000.0,
              f"[D3] {name}: values outside [100, 1000]")
        if device.type == "cuda":
            check(counts["sell_spmv"]["launches"] > 0,
                  f"[D3] {name}: the sliced-ELL kernel was not launched")
        out[name] = dict(dof=sy.n_free, iterations=res.iterations,
                         host_relres=rr, wall_s=wall, phases_s=phases,
                         ilu_levels=levels, timesteps=len(times),
                         launches=counts)
    return out


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


def _skewed_csr(n_slices: int, seed: int):
    """Square CSR whose 32-row slices have widths 1, 200, 0 (empty) and
    random 1..30 side by side: the chunked kernel's hard shapes."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.ops.csr import CSRMatrix

    rng = np.random.default_rng(seed)
    n = n_slices * 32
    kinds = np.arange(n) // 32 % 4
    lens = np.where(kinds == 0, 1, 0)
    lens = np.where(kinds == 1, rng.integers(150, 201, n), lens)
    lens = np.where(kinds == 3, rng.integers(1, 31, n), lens)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=indptr[1:])
    rows = np.repeat(np.arange(n), lens)
    pos = np.arange(rows.size) - indptr[rows]
    # Distinct columns per row (stride n // 256 > the widest row), sorted.
    cols = (rows * 37 + pos * (n // 256)) % n
    order = np.lexsort((cols, rows))
    return CSRMatrix(indptr=indptr, indices=cols[order].astype(np.int64),
                     data=rng.normal(size=rows.size), shape=(n, n))


def compare_phase(device, run_a, run_b, run_c, run_d1, run_d2) -> dict:
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
    compare_path_d(device, run_d1, run_d2, errs, vec)
    return errs


def compare_path_d(device, run_d1, run_d2, errs, vec) -> None:
    """Kernels 2 and 5 against their plain versions (adds to ``errs``)."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import (
        bsg_from_csr,
        bsg_spmv,
        spmv_plain,
    )

    # Kernel 2: path D2's ragged operator, then skewed slices.
    R = run_d2["R"]
    x32 = vec(R.n_pad)
    for name, x, tol in (("float32", x32, TOL_F32),
                         ("float64", x32.double(), TOL_F64)):
        y = bsg_spmv(R, x)
        _compare(f"chunked ELL path D2 ({R.n_chunks} chunks of 16, {name} "
                 f"vectors)", y, spmv_plain(R, x), tol, errs,
                 "sell_chunked_spmv")
        check(torch.equal(y, bsg_spmv(R, x)),
              f"[D] chunked ELL path D2 ({name}): two launches differ")
    skew = _skewed_csr(4096, seed=7)
    for chunk in (1, 3, 16):
        for storage, name, tol in (("float32", "float32", TOL_F32),
                                   ("float32", "float64", TOL_F64),
                                   ("float64", "float64", TOL_F64)):
            S = bsg_from_csr(skew, reorder=False, storage=storage,
                             layout="ragged", chunk=chunk, device=device)
            x = vec(S.n_pad, getattr(np, name))
            y = bsg_spmv(S, x)
            _compare(f"chunked ELL skewed widths 1/200/0 (chunk {chunk}, "
                     f"{S.wide.numel()} chunks spread one per warp, "
                     f"{storage} storage)", y, spmv_plain(S, x), tol,
                     errs, "sell_chunked_spmv")
            check(torch.equal(y, bsg_spmv(S, x)),
                  f"[D] chunked ELL chunk {chunk}: two launches differ")

    # Kernel 5: the fused solve against its plain recurrence, both sizes.
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        _inverse_diagonal,
        fused_cg_plain,
        fused_cg_solve,
    )

    for label in ("833k", "16k"):
        A, b = run_d1[label]["A"], run_d1[label]["b"]
        rf = fused_cg_solve(A, b, tol=PCG_TOL, maxiter=PCG_MAXITER)
        rp = fused_cg_plain(A, b, torch.zeros_like(b), _inverse_diagonal(A),
                            tol=PCG_TOL, maxiter=PCG_MAXITER)
        sync(device)
        diff = (rf.x.double() - rp.x.double()).abs().max().item()
        rel = diff / rp.x.double().abs().max().item()
        log(f"[D] fused CG {label}: kernel {rf.iterations} iterations, plain "
            f"{rp.iterations}; max rel diff of x {rel:.3e} (limit 1e-4)")
        check(abs(rf.iterations - rp.iterations) <= 2,
              f"[D] fused CG {label}: iterations differ by more than 2")
        check(rel <= 1e-4, f"[D] fused CG {label}: x differs by {rel:.3e}")
        errs["fused_cg"] = max(errs.get("fused_cg", 0.0), diff)


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


def profile_cold(fn, scrub, kernel: str, reps: int = 20) -> float:
    """Device ms per call of the kernels whose name holds ``kernel``, with
    the 50 MB L2 flushed before each call (a 256 MB buffer rewritten),
    from the profiler: event timing of a launch this short would measure
    the host's dispatch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                scrub.add_(1.0)
                fn()
            torch.cuda.synchronize()
        ev = [e for e in _device_events(prof) if kernel in e[0]]
        if len(ev) == reps:
            break
        log(f"profiler: cold trace {attempt + 1} held {len(ev)} launches")
    check(len(ev) == reps, f"the profiler recorded {len(ev)} of {reps} "
          f"launches of {kernel}")
    return sum(t - s for _n, s, t in ev) / 1e3 / reps


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


def timing_phase(device, card, run_a, run_b, run_c, run_d1, run_d2) -> dict:
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
    scrub = torch.empty(64 * 2**20, dtype=torch.float32, device=device)
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
        b_ms, b_by, nbytes = _pad_bound(A, x)
        cold = profile_cold(lambda: A.matvec(x), scrub, "pad_stencil_kernel")
        log(f"[E] pad-stencil 1M ({name} vectors, {A.n_pad} slots), device "
            f"ms per call: kernel {t['kernel']['device_ms']}, plain "
            f"{t['plain']['device_ms']}, cuSPARSE CSR ({S.nnz} nnz) "
            f"{t['library']['device_ms']}; events back to back: "
            f"{json.dumps({k: v['events_ms'] for k, v in t.items()})}; kernel "
            f"with L2 flushed before each call {cold} ms; bound {b_ms} ms by "
            f"{b_by} ({nbytes / 1e6:.2f} MB) [{card}]")
        rec[f"pad_stencil/{name}"] = dict(
            ms=t["kernel"]["device_ms"], plain_ms=t["plain"]["device_ms"],
            library_ms=t["library"]["device_ms"], bound_ms=b_ms,
            bound_by=b_by, cold_ms=cold,
            events_ms={k: v["events_ms"] for k, v in t.items()})
        del Acsr
    k3 = rec["pad_stencil/float32"]
    k3["f64_ms"] = rec["pad_stencil/float64"]["ms"]
    k3["f64_cold_ms"] = rec["pad_stencil/float64"]["cold_ms"]
    k3["depths"] = time_pad_depths(device, card, A, sy, rng, scrub)
    del scrub

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
    rec.update(time_chunked(device, card, run_c, run_d2, rec["sell_spmv"],
                            nbytes))
    rec.update(time_fused(card, run_d1))
    return rec


def _pad_bound(A, x) -> tuple:
    """Kernel 3's bound: x and corr on the real nodes only (pad slots of x
    hold 0 and corr is not needed there), y on every slot (pads are
    written 0); flops per real node: the taps' adds, a multiply-add per
    group, the correction's."""
    vb = x.element_size()
    nbytes = A.n_rows * (vb + A.corr.element_size()) + A.n_pad * vb
    flops = A.n_rows * (len(A.taps) + 2 * len(A.groups) + 2)
    return (*bound(nbytes, flops), nbytes)


# Kernel 3's z-layers per block, timed beside the launch's own choice (0).
PAD_DEPTHS = (0, 1, 2, 4, 8, 16)
BIG_CELLS = 216  # a 10M-DOF box's free grid: 215 x 217 x 217, mxp = 256


def time_pad_depths(device, card, A, sy, rng, scrub) -> dict:
    """Kernel 3 in f32 at every z-depth of PAD_DEPTHS, on path A's
    operator and on a 10M-DOF space of the same stencil (mxp = 256), each
    against the plain version; device ms per call, and with L2 flushed
    for the launch's own choice.  Launches here do not count."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        pad_stencil_from_parts,
    )

    n = BIG_CELLS - 1, BIG_CELLS + 1, BIG_CELLS + 1
    parts = dict(pats=A.pats.cpu().numpy(), const_vals=A.const_vals.cpu().numpy(),
                 corr_pad=np.zeros(n[0] * n[1] * n[2], np.float32),
                 taps=A.taps, groups=A.groups, group_const=A.group_const,
                 dims=n, period=A.period)
    big = pad_stencil_from_parts(parts, device=device)
    out = {}
    for label, op in (("1M", A), ("10M", big)):
        x = op.put_vector(rng.normal(size=op.n_rows), dtype=torch.float32)
        y_ref = op.matvec_reference(x)
        b_ms, b_by, nbytes = _pad_bound(op, x)
        times = {}
        for zc in PAD_DEPTHS:
            y = _kernels.pad_stencil_launch(op, x, z_layers=zc)
            sync(device)
            check(torch.equal(y, op.matvec(x)),
                  f"[E] pad-stencil {label} z-depth {zc}: not bit-identical "
                  f"to the launch's own choice")
            times[str(zc)] = profile_device(
                lambda: _kernels.pad_stencil_launch(op, x, z_layers=zc)
            )["device_ms"]
        err = (y.double() - y_ref.double()).abs().max().item() / max(
            y_ref.double().abs().max().item(), 1e-300)
        check(err <= TOL_F32, f"[E] pad-stencil {label}: rel err {err:.3e}")
        cold = profile_cold(lambda: op.matvec(x), scrub, "pad_stencil_kernel")
        log(f"[E] pad-stencil {label} f32, dims {op.dims}, (Z, myp, mxp) = "
            f"({op.Z}, {op.myp}, {op.mxp}): device ms per call by z-layers "
            f"of a 4-row block (0 = the launch's choice): "
            f"{json.dumps(times)}; the launch's choice with L2 flushed "
            f"{cold} ms; bound {b_ms} ms by {b_by} ({nbytes / 1e6:.2f} MB); "
            f"max rel err vs plain {err:.3e} [{card}]")
        out[label] = dict(ms=times, cold_ms=cold, bound_ms=b_ms,
                          dims=list(op.dims), n_pad=op.n_pad)
    return out


def time_chunked(device, card, run_c, run_d2, k1, k1_bytes) -> dict:
    """Kernel 2 on path D2's operator (chunk 16), beside kernel 1 and
    cuSPARSE on the same product.

    Its bound is kernel 1's: the same product of the same operator, whose
    compulsory bytes are the dense layout's slots, x and y; the ragged
    layout stores exactly those slots (slot ratio 1)."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import bsg_spmv, spmv_plain

    R = run_d2["R"]
    csr = run_c["solver"].system.A
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=R.n_pad).astype(np.float32)).to(device)
    xo = x[R.perm].contiguous()
    Acsr = _csr_tensor(csr.indptr, csr.indices, csr.data, csr.n_cols,
                       torch.float32, device)
    t = _measure({
        "kernel": lambda: bsg_spmv(R, x),
        "plain": lambda: spmv_plain(R, x),
        "library": lambda: Acsr @ xo,
    })
    b_ms, b_by = k1["bound_ms"], k1["bound_by"]
    ratio = R.n_slots / run_c["solver"].operator.n_slots
    ms = t["kernel"]["device_ms"]
    log(f"[E] chunked ELL fine ({R.n_pad} rows, {R.n_chunks} chunks of 16, "
        f"{R.wide.numel()} spread one per warp, {R.n_slots} slots, slot "
        f"ratio {ratio:.4f}, f32), device ms per call: kernel {ms} (kernel 1 "
        f"on the dense layout {k1['ms']}: {ms / k1['ms']:.3f}x), plain "
        f"{t['plain']['device_ms']}, cuSPARSE CSR "
        f"{t['library']['device_ms']} ({ms / t['library']['device_ms']:.3f}x)"
        f"; events back to back: "
        f"{json.dumps({k: v['events_ms'] for k, v in t.items()})}; bound "
        f"{b_ms} ms by {b_by} (kernel 1's, {k1_bytes / 1e6:.2f} MB) [{card}]")
    return {"sell_chunked_spmv": dict(
        ms=ms, plain_ms=t["plain"]["device_ms"],
        library_ms=t["library"]["device_ms"], bound_ms=b_ms, bound_by=b_by,
        slot_ratio=ratio, vs_kernel_1=ms / k1["ms"],
        events_ms={k: v["events_ms"] for k, v in t.items()})}


def _wall_ms(fn, reps: int) -> list:
    import torch

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def time_fused(card, run_d1) -> dict:
    """Kernel 5 per solve at both sizes: wall (host clock around the solve
    and a synchronise) and device time (profiler), beside its plain
    recurrence and, as the yardstick, the unfused loop on kernel 1."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch.solvers import (
        cg_solve,
        fused_cg_solve,
    )
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        _inverse_diagonal,
        fused_cg_plain,
    )

    rec = {}
    for label in ("833k", "16k"):
        d = run_d1[label]
        A, b, M = d["A"], d["b"], d["M"]
        zero = torch.zeros_like(b)
        invd = _inverse_diagonal(A)
        fns = {
            "fused": lambda: fused_cg_solve(A, b, tol=PCG_TOL,
                                            maxiter=PCG_MAXITER),
            "unfused": lambda: cg_solve(A, b, zero, precond=M, tol=PCG_TOL,
                                        maxiter=PCG_MAXITER),
            "plain": lambda: fused_cg_plain(A, b, zero, invd, tol=PCG_TOL,
                                            maxiter=PCG_MAXITER),
        }
        walls = {k: [] for k in fns}
        for k in ("unfused", "fused", "plain", "plain", "fused", "unfused"):
            walls[k] += _wall_ms(fns[k], 2 if k == "fused" else 1)
        prof = {k: profile_device(fns[k], reps=3 if k == "fused" else 1)
                for k in fns}
        iters = d["fused"].iterations
        per_iter = (A.n_slots * 8 + A.slice_ptr.numel() * 8
                    + (A.x_len + VECTOR_PASSES * A.n_pad) * 4)
        setup = (A.n_slots * 8 + 5 * A.n_pad * 4)  # A x0, b, x0, D^-1, r, p
        nbytes = iters * per_iter + setup
        b_ms, b_by = bound(nbytes, iters * (2 * A.n_slots + 12 * A.n_pad))
        dev = prof["fused"]["device_ms"]
        unf = prof["unfused"]
        idle = 1.0 - unf["busy_ms"] / unf["wall_ms"]
        log(f"[E] fused CG {label} ({A.n_pad} rows, {iters} iterations; "
            f"unfused {d['unfused'].iterations}): wall ms per solve fused "
            f"{walls['fused']}, unfused {walls['unfused']}, plain "
            f"{walls['plain']}; device ms per solve fused {dev} "
            f"({dev * 1e3 / iters:.2f} us per iteration), unfused "
            f"{unf['device_ms']} (busy {unf['busy_ms']} of "
            f"{unf['wall_ms']} ms under the profiler, idle share {idle}), "
            f"plain {prof['plain']['device_ms']}; bound {b_ms} ms by {b_by} "
            f"({b_ms * 1e3 / iters:.2f} us per iteration, "
            f"{nbytes / 1e6:.1f} MB) [{card}]")
        rec[f"fused_cg/{label}"] = dict(
            ms=dev, plain_ms=prof["plain"]["device_ms"], bound_ms=b_ms,
            bound_by=b_by, library_ms=None, iterations=iters,
            us_per_iteration=dev * 1e3 / iters,
            wall_ms=walls["fused"], plain_wall_ms=walls["plain"],
            yardstick="unfused cg_solve + Jacobi on the sliced-ELL kernel",
            yardstick_ms=min(walls["unfused"]),
            yardstick_wall_ms=walls["unfused"],
            yardstick_device_ms=unf["device_ms"],
            yardstick_idle_share=idle,
            unfused_iterations=d["unfused"].iterations)
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
    run_d1 = phase_d1(device, kernels, run_c)
    run_d2 = phase_d2(device, kernels, run_c, run_d1)
    log(f"[D2] done at {time.perf_counter() - t_start:.1f} s")
    run_d3 = phase_d3(device, kernels)
    log(f"[D3] done at {time.perf_counter() - t_start:.1f} s")

    # ---- D. kernels against plain versions (launches not counted) --------
    errs = compare_phase(device, run_a, run_b, run_c, run_d1, run_d2)

    # ---- E. timing and records --------------------------------------------
    rec = timing_phase(device, card, run_a, run_b, run_c, run_d1, run_d2)
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
        "jacobi_pcg": {
            label: {
                "dof": run_d1[label]["system"].n_free,
                "iterations": [run_d1[label]["unfused"].iterations,
                               run_d1[label]["fused"].iterations],
                "first_wall_ms": list(run_d1[label]["wall_ms"]),
                "host_relres": run_d1[label]["host_relres"],
            } for label in ("833k", "16k")
        } | {"launches": run_d1["counts"]},
        "ragged": {
            "chunks": run_d2["R"].n_chunks,
            "slots": run_d2["R"].n_slots,
            "iterations": {"jacobi": run_d2["jacobi"].iterations,
                           "amg": run_d2["amg"].iterations,
                           "amg_dense": run_d2["amg_dense"].iterations},
            "host_relres": run_d2["host_relres"],
            "pack_s": run_d2["t_pack"],
            "amg_setup_s": run_d2["t_amg"],
            "launches": run_d2["launches"],
        },
        "cli_routes": run_d3,
        "timing": rec,
        "total_s": time.perf_counter() - t_start,
    }))
    main_shape = {"sell_spmv": ("sell_spmv", run_c["counts"]),
                  "pad_stencil": ("pad_stencil/float32", run_a["counts"]),
                  "dia_spmv": ("dia_spmv/level 1", run_a["counts"]),
                  "sell_chunked_spmv": ("sell_chunked_spmv", run_d2["counts"]),
                  "fused_cg": ("fused_cg/833k", run_d1["counts"])}
    records = []
    for k in kernels:
        key, counts = main_shape[k.name]
        r = rec[key]
        extra = {f: r[f] for f in ("yardstick", "yardstick_ms", "slot_ratio",
                                   "vs_kernel_1", "cold_ms", "f64_ms",
                                   "f64_cold_ms") if f in r}
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
            **extra,
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
