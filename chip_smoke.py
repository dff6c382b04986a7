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
   the sliced-ELL kernel; answers checked as before.  The fine operator
   stores its values as int8 (JAX's ``storage="auto"`` for the graph
   Laplacian), so kernel 1 runs its int8 instance here.
D1. Jacobi-PCG in one launch (the fused CG kernel) against the unfused
   ``cg_solve`` with the Jacobi preconditioner on the sliced-ELL kernel, on
   path C's 833,048-DOF operator and on the 16,028-DOF
   ``refine_uniform(box_mesh(13, 13, 13, "TETRA4"), 1)`` (the size of the
   reference's tet-cube-heat, L2-resident), f32 to 1e-6: both converge,
   iterations within max(2, 2 %), host f64 relres <= 5e-6 plus the f32
   rounding floor eps/2 * || |A| |u| || / ||b|| (hundreds of f32 updates
   at the answer's scale), with u a host f64 Jacobi-PCG answer to 1e-10
   computed before either solve; each fused solve launches exactly one C
   entry of any kernel: the cluster instance's at 16k, the grid
   instance's at 833k.
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
F. This slice's paths, in a process of its own (``--phase-f``: the
   profiler of a process that has run them loses device records, which
   phase E needs), each run with every launch counter at 0 just before it
   and read just after, in about two minutes:
   F1. On path A's system (1,009,899 DOF) and its f64 DIA operator (bf16
   storage, the DIA kernel): ``lanczos_extremes(k=40)`` from a
   ``default_rng(0)`` start: 0 < lmin, lmax <= the host Gershgorin bound and
   within 1e-8 relative of the same 40 steps in numpy on the host CSR (an
   independent implementation: modified Gram-Schmidt, scipy products).
   Then ``transient_heat_solve(dt=0.2, n_steps=40, tol=1e-10)`` as
   ``examples/04_transient.py`` runs it: the last step's shifted system has
   a host f64 relres <= 1e-9; every value lies in [0, 1000] (the shifted
   Laplacian is an M-matrix) within tol * max ||rhs||, the error bound of a
   step solved to tol; the host ||A u - b|| never rises from step to step.
   F2. ``cg_solve_resumable`` on F1's operator, Jacobi, 1e-10, a checkpoint
   every 20 iterations: stopped at 60, then resumed, it takes the unbroken
   run's iterations and lands on its answer bit for bit.  Then the CLI's
   ``--checkpoint`` route (f64 CG+AMG to 1e-12, a checkpoint every 5) on
   ``box_mesh(20, 20, 20, "TETRA4")``: capped at 10 iterations it exits 1,
   run again it exits 0 with the unbroken run's iterations and answer, and
   the file's host relres is <= 1.5e-8.
   F3. ``cli.matrix_test`` on path A's Exodus file (1,030,301 rows, the
   full-mesh Laplacian as f64 ELL, a plain PyTorch product as JAX's is an
   XLA one): 500 power iterations at 1e-2, a report every 50; exit 0, and
   the printed lambda_max at or below the host Gershgorin bound of the
   Laplacian and within 1e-10 relative of the same power iterations in
   numpy on the host CSR from the same ``default_rng(0).uniform`` start.
   F4. P1 finite elements on ``box_mesh(100, 100, 100, "TETRA4")`` with
   Dirichlet u = 5 on x = 0 and sideset 77 on x = 1
   (``examples/05_fem_flux_bcs.py``): Neumann g = 3.25, then Robin
   (alpha, u_env) = (2, 11), each ``choose_operator`` (f64 DIA) plus
   ``smoothed_aggregation_setup``, f64 CG+AMG to 1e-13; the maximum error
   against the exact linear solution <= 1e-6.  The DIA kernel on each fine
   operator (19 diagonals, f64 storage: the instance this path takes, not
   D's) and the sliced-ELL kernel on each AMG level and transfer, against
   their plain versions at 1e-12 relative, the DIA kernel's instances and
   blocks bit-identical as in D.
   F5. P2 on ``box_mesh(24, 24, 24, "TETRA4")`` and Q2 on
   ``box_mesh(24, 24, 24, "HEX8")`` (117,649 nodes each; at 1M DOF the
   host COO assembly alone would hold 75-91 M triplets), f64 CG+AMG to
   1e-13 on the sliced-ELL kernel; the maximum error against the
   manufactured quadratic <= 1e-8.  The sliced-ELL kernel on the P2 and
   Q2 fine operators and their AMG levels, and the DIA kernel on Q2's
   coarse level, against their plain versions as in F4.
   F6. ``cli.decompose``, ``cli.assemble_test`` and ``cli.combine`` on F2's
   box: each exits 0 (four blocks; "OK"; every dumped row merged).
   Each of F1, F2 and F4 launches the DIA kernel and F5 the sliced-ELL
   kernel; the ``kernels`` line lists every kernel's launches per run, and
   its ``max_abs_err`` covers F4's and F5's comparisons too (these
   launches do not count).
   Then each counted solve runs again under the profiler: device time,
   busy time, wall and idle share, and the time in the port's kernels
   (a trace missing one of the counted run's launches is taken again).
G. The BASELINE's 10M box, in a process of its own as F (``--phase-g``),
   by ``bench10m.py``'s route through the port's public functions:
   ``structured_box_system(217, 217, 217, "TETRA4")`` (10,265,184 free
   DOF, one native pass, no mesh), ``structured_box_parts`` built on the
   card, ``pad_stencil_from_parts`` (kernel 3 in a 222 x 224 x 256 padded
   space), brick AMG with the pad-stencil level 0, a DIA level 1 (kernel
   4) and sliced-ELL levels 2 and 3 (kernel 1), CG+AMG to 1e-6 in f32,
   then ``iterative_refinement_solve`` to 1e-8
   with the staged f64 right-hand side and the residual on the card, the
   launch counters at 0 just before the two solves.  The device-built b
   and degree equal the assembled ones; both converge; the host f64
   relres of the answer <= 1.5e-8; 2-3 sweeps (JAX's record of the route:
   2); every value within [100, 1000]; kernel 3 ran in f32 and f64 and
   kernels 4 and 1 ran.  Then kernel 3 (f32, f64) on the 10M operator,
   kernel 4 on the DIA level and kernel 1 on the sliced-ELL levels against
   their plain versions (kernel 4 at every instance and block,
   bit-identical), the two solves under the profiler,
   kernel 3 at every z-depth and with L2 flushed, beside cuSPARSE on the
   CSR, and kernel 4 on level 1 beside its launch floor.
H. The domain-decomposed solve, in a process of its own as F and G
   (``--phase-h``), every part on the one card:
   H1. The CLI's halo route with the global AMG: path C's mesh
   (833,048 DOF) written as Exodus, ``--partitions 4 --precond amg
   --dtype float32 --tolerance 1e-6 --no-snapshots``: exit 0, CG
   iterations within 2 of path C's single-device CG+AMG count, host f64
   relres <= 2e-6, the file's values within [100, 1000], kernel 1
   launched (the coarse tail); the CLI's phases, partition and halo plan
   included, recorded.
   H2. The API on H1's system with ``BSGShardedOperator`` (kernel 1 on
   each part's block, bf16 values) at P = 4 and 8: Jacobi-CG to 1e-6
   within 2 iterations of D1's unfused solve, host relres <= 5e-6 plus
   D1's f32 floor, exactly P launches per product; at P = 4 CG with H1's
   halo AMG over the sliced-ELL blocks within 2 iterations of H1, and
   block-Schwarz AMG with and without the two-level coarse correction,
   each converging in no more iterations than Jacobi.  Every part's
   launch against its plain version (relative 1e-6 in f32), its halo
   rows exactly 0, its bf16 storage bit-identical to float32 storage.
   H3. GMRES with per-part ILUT (``build_block_ilu``), f64, to 1e-8 over
   4 parts on the 16,028-DOF mesh: converges, host relres <= 1.5e-8,
   iterations <= partitioned Jacobi-GMRES + 2, which is within 2 of the
   single-device GMRES + Jacobi (JAX's leg 1d).
   H4. ``cli.matrix_test --partitions 4`` on path A's file: lambda_max
   within 1e-8 relative of F3's single-device value.
   Then kernel 1 per part under the profiler against its bound (the
   compulsory bytes of that part's slots), its plain version and
   cuSPARSE on the same block, the partitioned product and the halo
   exchange by CUDA events, and H2's solves again under the profiler
   (device, busy, wall, idle share).
I. The structured slab engines, in a process of its own as F, G and H
   (``--phase-i``), four slabs on the one card:
   I1. The CLI's structured route on path A's file: ``--partitions 4
   --precond amg --dtype float64 --tolerance 1e-8 --no-snapshots``, the
   refinement over pad-stencil slabs (L = 30) with kernel 3 in f32 and
   f64 on every slab's window: exit 0, the slab-pad AMG, host f64 relres
   <= 1.5e-8 read back from the file, path A's sweeps and its inner
   iterations within one per sweep, values in [100, 1000], both kernel-3
   instances launched; the CLI's phases recorded.
   I2. The slab API on I1's system: the slab-pad AMG in f32 to 1e-6
   within one iteration of the single-device CG+AMG on the same pad
   operator and hierarchy (host relres <= 2e-6); Jacobi-CG over the slabs
   within max(2, 2 %) of the single-device Jacobi-CG on the pad operator;
   the global AMG over slab DIA in f64 within one iteration of the
   slab-pad count; CG with the brick-Schwarz preconditioner in no more
   iterations than slab Jacobi-CG.  Every part's window launch against its
   plain version (f32 1e-6, f64 1e-12 relative), guard layers, dead
   layers and pad slots exactly 0.
   I3. The 10M box (phase G's system) over four slabs of L = 66 at bz = 4:
   CG+AMG to 1e-6 in f32 within one iteration of phase G's, the
   refinement to 1e-8 in 2-3 sweeps with a host relres <= 1.5e-8, every
   kernel-3 launch a window launch; every part's window against its plain
   version.  Then kernel 3 per part under the profiler against its bound,
   the exchange and the slab product, and the counted solves under the
   profiler (device, busy, wall, idle share).
J. The multi-process decomposition, in a process of its own as F-I
   (``--phase-j``), which starts two worker processes
   (``--phase-j-worker RANK 2 URL OUT``, ``URL`` a ``file://`` rendezvous
   in ``OUT``) on the one card over gloo, each
   holding two of four parts, every wait bounded (a worker that fails or
   outlives ``J_TIMEOUT`` fails the phase):
   J1. ``box_mesh(100, 100, 100, "HEX8")`` written as Exodus (1,009,899
   free rows): ``assemble_heat_multihost``, each process reading only its
   element slice; rank 0's blocks bit-identical to ``build_halo_plan``'s
   slices of the global system; one product against the host CSR (1e-9);
   f64 Jacobi ``sharded_cg_solve`` to 1e-8 within one iteration of this
   process's one-process solve over the same 4 parts, host relres
   <= 1.5e-8.
   J2. ``BSGShardedOperator`` on J1's blocks in f32 (kernel 1 on each
   local part): exactly 2 launches per product in each process, each
   part's launch against its plain version (1e-6 relative), Jacobi-CG to
   1e-6 within max(2, 2 %) of one process, host relres <= 5e-6 plus the
   f32 floor.
   J3. ``multihost_slab_cg_solve`` on path A's system over 4 slabs, f32
   Jacobi to 1e-6: the same full answer in both processes, within max(2,
   2 %) iterations and 1e-5 of one process's, host relres <= 5e-6 plus
   the f32 floor; a sharded checkpoint of the iterate from each process,
   reassembled here bit for bit.
   Timed per process: J1's and J3's solves, one ``psum_dot``,
   ``halo_exchange`` and ``neighbour_strips`` across the processes (CUDA
   events) beside the same calls in one process, and the peak host RSS.
D. Every kernel against its plain PyTorch version on the card, on the
   paths' operators and a few more shapes (relative error limit 1e-5 in
   f32, 1e-12 in f64: the same products summed in another order, with
   fused multiply-adds; the fused CG solve within 2 iterations and 1e-4 of
   its plain recurrence; the chunked kernel also bit-identical over two
   launches).  The DIA kernel at every compiled instance it has for the
   shape, the run-time loop and every block of 32 to 256 threads, all
   bit-identical, on levels 1 and 2 of path A, path B's operator, a HEX8
   box (27 diagonals) and a random 11-diagonal operator.  The fused CG's
   cluster instance at 16k and on refined boxes of one and eight CTAs, and
   an operator of 17 CTAs that must take the grid instance, each
   bit-identical over two runs.  Restarts from a converged iterate (a
   refined box, two random graphs): the solve, the grid instance and the
   plain recurrence from the same iterate, beside its host relres and f32
   floor; the restart converges within one iteration of the plain one's,
   and stops at once where the iterate lies inside the tolerance by more
   than four floors.  The value storages: kernels 1 and 2 on path C's
   operator (int8-exact), a random bfloat16-exact Laplacian and a matrix
   of neither (200,000 rows each), in every storage that holds the values
   exactly, with f32 and f64 vectors, each within the limit of its plain
   version and bit-identical to the float32-storage launch; kernel 5 at
   833k (grid) and 16k (cluster) with int8, bfloat16 and float32 values:
   the same instance, iterations and answer bit for bit.  These launches
   do not count.
E. Times with CUDA events and the profiler: each kernel on its path's
   shape, its plain version and, as a yardstick the port never calls, one
   PyTorch call computing the same product (cuSPARSE through
   ``torch.sparse_csr_tensor @ x``); the pad-stencil product also with L2
   flushed between calls, at every z-depth of ``PAD_DEPTHS`` (each
   bit-identical to the launch's own choice; the 10M operator's in phase
   G); kernels 1, 2 and 5 in the storage ``storage="auto"`` keeps (int8)
   beside the same slots with float32 values; the DIA kernel on levels 1 and 2 of path
   A, path B's operator and the 1M fine operator beside its launch floor
   (a kernel that does nothing on the same grid) and one dependent load (a
   copy of n values on the same grid), at every block of ``DIA_BLOCKS`` and
   with the run-time loop; the fused CG solve against the unfused loop (no
   single PyTorch call solves CG), beside its synchronisation floor (the same
   launch with only the barriers and reductions of every iteration) and
   with the matvec but no vector updates, in the instance each size takes
   and, at 16k, in the grid instance too.  Print the kernel record, the
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


# Appended to every line a process logs (phase I's process sets it to the
# card's name and power limit).
LOG_TAG = ""


def log(msg: str) -> None:
    if LOG_TAG and not msg.endswith(LOG_TAG):
        msg += LOG_TAG
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
                     "by_entry": {e: n for e, n in k.by_entry.items() if n},
                     "by_form": dict(k.by_form)}
            for k in kernels}


def launch_delta(kernels, fn, entries=None):
    """Run ``fn`` (then synchronise); returns its result and the launches
    of every kernel during it.  With a dict ``entries``, also fill it with
    the launches of every C entry launched during it."""
    import torch

    before = {k.name: k.launches for k in kernels}
    by = {(k.name, e): n for k in kernels for e, n in k.by_entry.items()}
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if entries is not None:
        entries.update({e: n - by[(k.name, e)] for k in kernels
                        for e, n in k.by_entry.items() if n != by[(k.name, e)]})
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
    log(f"[C] setup (assembly + operator + AMG): {t_setup:.3f} s; fine "
        f"operator values stored as {solver.operator.storage} (JAX's "
        f"storage='auto' for the graph Laplacian)")
    check(solver.operator.storage == "int8",
          f"[C] the fine operator stores {solver.operator.storage}, not int8")
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


def _fused_entry_name(instance: str, A) -> str:
    """The C entry of kernel 5 that a solve on ``A`` launches."""
    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels

    base = "_cluster" if instance == "cluster" else ""
    return f"ddps_fused_cg{base}_{_kernels._NAME[A.vals.dtype]}"


def phase_d1(device, kernels, run_c, small_cells: int = SMALL_CELLS) -> dict:
    """Fused Jacobi-PCG against the unfused loop at 833k and 16k DOF."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch.solvers import (
        cg_solve,
        fused_cg_solve,
        jacobi_preconditioner,
    )
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        fused_cg_plan,
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
        ef = {}
        rf, df = launch_delta(kernels, lambda: fused_cg_solve(
            A, b, tol=PCG_TOL, maxiter=PCG_MAXITER), ef)
        wall_f = (time.perf_counter() - t0) * 1e3
        rr = [host_relres(sy.A, A.get_vector(r.x), sy.b) for r in (ru, rf)]
        slack = max(2, int(0.02 * ru.iterations))
        plan = fused_cg_plan(A)
        log(f"[D1] {label} ({sy.n_free} DOF, {A.n_slots} slots): unfused "
            f"{ru.iterations} iterations in {wall_u:.1f} ms (launches "
            f"{json.dumps(du)}), fused ({plan.instance} instance) "
            f"{rf.iterations} in {wall_f:.1f} ms (launches by entry "
            f"{json.dumps(ef)}); host f64 relres {rr[0]:.3e} / "
            f"{rr[1]:.3e} (limit {limit:.3e}: 5e-6 + the f32 floor "
            f"{floor:.3e} of the host f64 answer, {k_ref} iterations to "
            f"1e-10 in {t_ref:.1f} s)")
        check(ru.converged and rf.converged, f"[D1] {label}: not converged")
        check(abs(rf.iterations - ru.iterations) <= slack,
              f"[D1] {label}: iterations {rf.iterations} vs {ru.iterations}")
        check(max(rr) <= limit, f"[D1] {label}: host relres {rr}")
        if device.type == "cuda":
            want = _fused_entry_name(plan.instance, A)
            check(ef == {want: 1} and sum(df.values()) == 1,
                  f"[D1] {label}: launches in the fused solve {ef}, want "
                  f"one of {want}")
            check(du["sell_spmv"] > 0 and du["fused_cg"] == 0,
                  f"[D1] {label}: launches in the unfused solve {du}")
        out[label] = dict(system=sy, A=A, b=b, M=M, unfused=ru, fused=rf,
                          wall_ms=(wall_u, wall_f), host_relres=rr,
                          floor=floor, limit=limit, entries=ef,
                          instance=plan.instance)
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
# F. Slice 6: transient heat and Lanczos, resumable CG, the matrix test, the
#    finite-element models and the host drivers
# ---------------------------------------------------------------------------

QUAD_CELLS = 24  # P2 / Q2 boxes of 24^3 cells: 117,649 nodes each


def _host_lanczos(S, z0, k: int) -> float:
    """lambda_max from k Lanczos steps in numpy on the host CSR, with
    modified Gram-Schmidt: an implementation independent of the port's."""
    import numpy as np

    V = np.zeros((k + 1, z0.size))
    V[0] = z0 / np.linalg.norm(z0)
    alphas, betas = np.zeros(k), np.zeros(k)
    for j in range(k):
        w = S @ V[j]
        alphas[j] = V[j] @ w
        w -= alphas[j] * V[j] + (betas[j - 1] * V[j - 1] if j else 0.0)
        for i in range(j + 1):
            w -= (V[i] @ w) * V[i]
        betas[j] = np.linalg.norm(w)
        V[j + 1] = w / betas[j]
    T = np.diag(alphas) + np.diag(betas[:-1], 1) + np.diag(betas[:-1], -1)
    return float(np.linalg.eigvalsh(T)[-1])


def _host_power(S, z0, iterations: int) -> float:
    """The Rayleigh quotient after ``iterations`` power steps in numpy on
    the host CSR ``S`` from ``z0``."""
    import numpy as np

    z, lam = z0, 0.0
    for _ in range(iterations):
        q = z / np.linalg.norm(z)
        z = S @ q
        lam = float(q @ z)
    return lam


def _run_counted(kernels, fn):
    """Run ``fn`` with every launch counter at 0 just before it; returns its
    result, the counts just after it and its wall time in seconds."""
    reset_counts(kernels)
    t0 = time.perf_counter()
    out = fn()
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, read_counts(kernels), time.perf_counter() - t0


def _launched(counts) -> str:
    """The kernels a counted run launched, by C entry, as JSON."""
    return json.dumps({k: c["by_entry"] for k, c in counts.items()
                       if c["launches"]})


def _want_launched(device, counts, names, tag) -> None:
    if device.type == "cuda":
        for name in names:
            check(counts[name]["launches"] > 0,
                  f"[{tag}] the {name} kernel was not launched")


def phase_f1(device, kernels, sy) -> dict:
    """Lanczos extremes and 40 implicit-Euler steps on the heat system's
    f64 DIA operator (kernel 4)."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.models import (
        transient_heat_solve,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import (
        DIAMatrix,
        choose_operator,
    )
    from domain_decomposed_pde_solver_tpu_torch.solvers import (
        lanczos_extremes,
    )

    A = choose_operator(sy.A, dtype=torch.float64, device=device)
    check(isinstance(A, DIAMatrix), f"[F1] operator {type(A).__name__}")
    S = sy.A.to_scipy().tocsr()
    z0 = np.random.default_rng(0).standard_normal(sy.n_free)
    z0_dev = A.put_vector(z0)
    lan, c_lan, t_lan = _run_counted(
        kernels, lambda: lanczos_extremes(A, z0_dev, k=40))
    gersh = float(abs(S).sum(axis=1).max())
    t0 = time.perf_counter()
    host_lmax = _host_lanczos(S, z0, 40)
    t_host = time.perf_counter() - t0
    log(f"[F1] Lanczos k=40 on {sy.n_free} DOF: lmin {lan.lmin:.10g}, lmax "
        f"{lan.lmax:.10g} (Gershgorin bound {gersh:g}; the same 40 steps "
        f"in numpy on the host CSR, modified Gram-Schmidt: {host_lmax:.10g}, "
        f"{t_host:.2f} s), condition {lan.condition:.6g}, {t_lan:.3f} s, "
        f"launches {_launched(c_lan)}")
    check(0.0 < lan.lmin, f"[F1] lmin {lan.lmin} <= 0")
    check(lan.lmax <= gersh * (1 + 1e-12), f"[F1] lmax {lan.lmax} > {gersh}")
    check(abs(lan.lmax - host_lmax) <= 1e-8 * host_lmax,
          f"[F1] lmax {lan.lmax} vs the host's {host_lmax}")
    _want_launched(device, c_lan, ["dia_spmv"], "F1")

    dt, steps, tol = 0.2, 40, 1e-10
    last, resid, rhs_norm = [], [], [0.0]

    def keep(step, t, u):
        prev = last[-1] if last else np.zeros(sy.n_free)
        rhs_norm[0] = max(rhs_norm[0], float(np.linalg.norm(prev + dt * sy.b)))
        last.append(u)
        del last[:-2]
        resid.append(float(np.linalg.norm(S @ u - sy.b)))

    tr, c_tr, t_tr = _run_counted(kernels, lambda: transient_heat_solve(
        sy, A, dt=dt, n_steps=steps, tol=tol, callback=keep))
    u_prev, u = last
    rhs = u_prev + dt * sy.b
    step_rr = float(np.linalg.norm(u + dt * (S @ u) - rhs) / np.linalg.norm(rhs))
    # A step solved to tol leaves ||e|| <= tol ||rhs|| / lambda_min(I + dt A)
    # and lambda_min >= 1: the slack of the maximum principle's bounds.
    slack = tol * rhs_norm[0]
    lo, hi = float(u.min()), float(u.max())
    rises = float(np.diff(resid).max())
    log(f"[F1] transient dt={dt}, {steps} steps: {tr.total_cg_iterations} CG "
        f"iterations in {t_tr:.3f} s (host residual checks included); last "
        f"step's host f64 relres {step_rr:.3e} (limit 1e-9); values "
        f"[{lo:.6g}, {hi:.6g}] (limits [0, 1000] -/+ {slack:.3e}); ||A u - "
        f"b|| {resid[0]:.6g} -> {resid[-1]:.6g}, largest step change "
        f"{rises:.6g}; launches {_launched(c_tr)}")
    check(step_rr <= 1e-9, f"[F1] last step's relres {step_rr:.3e} > 1e-9")
    check(-slack <= lo and hi <= 1000.0 + slack,
          f"[F1] values [{lo}, {hi}] outside [0, 1000]")
    check(rises <= 0.0, f"[F1] ||A u - b|| rose by {rises}")
    _want_launched(device, c_tr, ["dia_spmv"], "F1")
    replays = {
        "F1 lanczos": (lambda: lanczos_extremes(A, z0_dev, k=40), c_lan),
        "F1 transient": (lambda: transient_heat_solve(
            sy, A, dt=dt, n_steps=steps, tol=tol), c_tr),
    }
    return dict(A=A, replays=replays, lmin=lan.lmin, lmax=lan.lmax,
                host_lmax=host_lmax,
                gershgorin=gersh, lanczos_s=t_lan,
                cg_iterations=tr.total_cg_iterations, transient_s=t_tr,
                step_relres=step_rr, launches={"lanczos": c_lan,
                                               "transient": c_tr})


def phase_f2(device, kernels, sy, A, small_box: int = SMALL_BOX,
             out=OUT) -> dict:
    """The resumable CG on F1's operator (Jacobi, 1e-10, a checkpoint every
    20 iterations), stopped at 60 and resumed; then the CLI's --checkpoint
    route on a small box."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.io import (
        box_mesh,
        read_nodal_vars,
        write_exodus,
    )
    from domain_decomposed_pde_solver_tpu_torch.solvers import (
        cg_solve_resumable,
        jacobi_preconditioner,
    )
    from domain_decomposed_pde_solver_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )

    out.mkdir(parents=True, exist_ok=True)
    b = A.put_vector(sy.b)
    M = jacobi_preconditioner(A)
    paths = {k: out / f"f2_{k}.npz" for k in ("whole", "broken", "cli",
                                               "cli_whole")}
    for p in paths.values():
        p.unlink(missing_ok=True)

    def solve(path, maxiter):
        return cg_solve_resumable(A, b, torch.zeros_like(b),
                                  checkpoint_path=str(path),
                                  checkpoint_every=20, precond=M, tol=1e-10,
                                  maxiter=maxiter)

    whole, c_whole, t_whole = _run_counted(
        kernels, lambda: solve(paths["whole"], 20000))
    # Stopped at 60 iterations, or, on a box too small for that, at the
    # last checkpoint before the answer.
    stop = min(60, (whole.iterations - 1) // 20 * 20)
    first, c_first, _t = _run_counted(
        kernels, lambda: solve(paths["broken"], stop))
    saved = load_checkpoint(str(paths["broken"])).iteration
    rest, c_rest, t_rest = _run_counted(
        kernels, lambda: solve(paths["broken"], 20000))
    same = bool(torch.equal(rest.x, whole.x))
    rr = host_relres(sy.A, A.get_vector(whole.x), sy.b)
    log(f"[F2] resumable CG+Jacobi to 1e-10 on {sy.n_free} DOF: unbroken "
        f"{whole.iterations} iterations in {t_whole:.3f} s (host f64 relres "
        f"{rr:.3e}); stopped at {first.iterations} (checkpoint at {saved}), "
        f"resumed to {rest.iterations} in {t_rest:.3f} s; x bit-identical: "
        f"{same}; launches {_launched(c_whole)}")
    check(whole.converged and rest.converged, "[F2] not converged")
    check(stop >= 20 and first.iterations == stop and not first.converged
          and saved == stop,
          f"[F2] stopped at {first.iterations}, checkpoint at {saved}")
    check(rest.iterations == whole.iterations,
          f"[F2] resumed {rest.iterations} vs unbroken {whole.iterations}")
    check(same, "[F2] the resumed answer is not bit-identical")
    check(rr <= 1.5e-10, f"[F2] host relres {rr:.3e} > 1.5e-10")
    for c in (c_whole, c_first, c_rest):
        _want_launched(device, c, ["dia_spmv"], "F2")

    mesh = out / f"f2_box{small_box}.exo"
    write_exodus(str(mesh), box_mesh(small_box, small_box, small_box,
                                     "TETRA4"))
    base = ["--input", mesh, "--dtype", "float64", "--precond", "amg",
            "--tolerance", "1e-12", "--checkpoint-every", "5"]
    if device.type != "cuda":
        base.append("--cpu")
    runs = {}
    for label, extra in (("capped", ["--checkpoint", paths["cli"],
                                     "--iterations", "10"]),
                         ("resumed", ["--checkpoint", paths["cli"]]),
                         ("unbroken", ["--checkpoint", paths["cli_whole"]])):
        rep = {}
        sol = out / f"f2_{label}.exo"
        rc, wall, counts = run_cli(base + extra + ["--solution", sol], rep,
                                   kernels)
        runs[label] = dict(rc=rc, wall=wall, counts=counts,
                           iterations=rep["result"].iterations,
                           u=read_nodal_vars(str(sol))[2][-1, 0],
                           system=rep["system"])
    sy2 = runs["resumed"]["system"]
    rr2 = host_relres(sy2.A, runs["resumed"]["u"][sy2.free_to_node], sy2.b)
    log(f"[F2] CLI --checkpoint on box_mesh({small_box}^3), {sy2.n_free} "
        f"DOF, CG+AMG to 1e-12: capped rc {runs['capped']['rc']} at "
        f"{runs['capped']['iterations']}, resumed rc {runs['resumed']['rc']} "
        f"at {runs['resumed']['iterations']}, unbroken "
        f"{runs['unbroken']['iterations']}; host relres {rr2:.3e} (limit "
        f"1.5e-8); walls {[round(r['wall'], 3) for r in runs.values()]} s")
    check(runs["capped"]["rc"] == 1 and runs["capped"]["iterations"] == 10,
          "[F2] the capped CLI run did not stop at 10 iterations")
    check(runs["resumed"]["rc"] == 0, "[F2] the resumed CLI run failed")
    check(runs["resumed"]["iterations"] == runs["unbroken"]["iterations"]
          and np.array_equal(runs["resumed"]["u"], runs["unbroken"]["u"]),
          "[F2] the resumed CLI run differs from the unbroken one")
    check(rr2 <= 1.5e-8, f"[F2] CLI host relres {rr2:.3e} > 1.5e-8")
    for r in runs.values():
        _want_launched(device, r["counts"], ["dia_spmv"], "F2")
    def replay():
        paths["whole"].unlink()
        return solve(paths["whole"], 20000)

    return dict(replays={"F2 resumable": (replay, c_whole)},
                iterations=whole.iterations, whole_s=t_whole,
                resumed_s=t_rest, host_relres=rr, bit_identical=same,
                cli_iterations=runs["resumed"]["iterations"],
                cli_host_relres=rr2,
                launches={"whole": c_whole, "cli": runs["resumed"]["counts"]})


def _captured(fn):
    """Run ``fn`` with standard output captured; log and return it."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"    | {line}")
    return rc, text


def phase_f3(device, kernels, exo, rows: int) -> dict:
    """The matrix test (power method, 500 iterations, 1e-2, a report every
    50) on the full-mesh Laplacian of ``exo``, a mesh of ``rows`` nodes."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.cli.matrix_test import main
    from domain_decomposed_pde_solver_tpu_torch.solvers import power_method

    rep = {}
    args = ["--input", str(exo)] + ([] if device.type == "cuda" else ["--cpu"])
    (rc, text), counts, wall = _run_counted(
        kernels, lambda: _captured(lambda: main(args, report=rep)))
    final = text.strip().splitlines()[-1]
    L, res = rep["laplacian"], rep["result"]
    S = L.to_scipy().tocsr()
    z0_host = np.random.default_rng(0).uniform(size=L.n_rows)
    gersh = float(abs(S).sum(axis=1).max())
    # "lambda_max ~= <lambda> after <iterations> iterations (...)"
    words = final.split()
    printed, done = float(words[2]), int(words[4])
    t0 = time.perf_counter()
    host_lam = _host_power(S, z0_host, done)
    t_host = time.perf_counter() - t0
    log(f"[F3] matrix test on {L.n_rows} rows ({L.nnz} nnz): rc {rc}, wall "
        f"{wall:.2f} s; final line: {final}; lambda_max {res.eigenvalue:.17g}"
        f" (Gershgorin bound {gersh:g}; the same {done} iterations in numpy "
        f"on the host CSR: {host_lam:.17g}, {t_host:.2f} s)")
    check(rc == 0, f"[F3] the matrix test exited with {rc}")
    check(L.n_rows == rows, f"[F3] {L.n_rows} rows, want {rows}")
    check(final.startswith("lambda_max ~= "), f"[F3] final line {final!r}")
    check(abs(printed - res.eigenvalue) <= 1e-8 * abs(res.eigenvalue),
          f"[F3] printed {printed} vs the result's {res.eigenvalue}")
    check(0.0 < res.eigenvalue <= gersh * (1 + 1e-12),
          f"[F3] lambda_max {res.eigenvalue} outside (0, {gersh}]")
    check(abs(res.eigenvalue - host_lam) <= 1e-10 * abs(host_lam),
          f"[F3] lambda_max {res.eigenvalue} vs the host's {host_lam}")
    A = rep["operator"]
    z0 = A.put_vector(z0_host)
    # One call with a check every 50 is the matrix test's chunked loop.
    replays = {"F3 power": (lambda: power_method(
        A, z0, maxiter=500, tol=1e-2, check_every=50), counts)}
    return dict(replays=replays, rows=L.n_rows, eigenvalue=res.eigenvalue,
                host_eigenvalue=host_lam, gershgorin=gersh,
                residual=res.residual, converged=res.converged, wall_s=wall,
                final_line=final, launches=counts)


def _plane_sideset(mesh, ss_id: int, xval: float):
    """All tet faces on the plane x == xval as an Exodus sideset, as
    ``examples/05_fem_flux_bcs.py`` builds it."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.io import SideSet, side_local_nodes

    on = np.isclose(mesh.coords[:, 0], xval)
    elems, sides, off = [], [], 0
    for blk in mesh.blocks:
        for s in range(1, 5):
            hit = on[blk.conn[:, list(side_local_nodes("TETRA4", s))]].all(1)
            e = np.nonzero(hit)[0]
            elems.append(e + off)
            sides.append(np.full(e.size, s))
        off += blk.conn.shape[0]
    return SideSet(id=ss_id, elems=np.concatenate(elems),
                   sides=np.concatenate(sides))


def _fem_solve(device, kernels, sy, tol):
    """f64 CG+AMG on ``choose_operator`` and ``smoothed_aggregation_setup``
    of an assembled system; returns (answer, result, counts, times, a
    replay of the solve with its counts, (operator, AMG))."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops.dia import choose_operator
    from domain_decomposed_pde_solver_tpu_torch.solvers import (
        cg_solve,
        smoothed_aggregation_setup,
    )

    t0 = time.perf_counter()
    A = choose_operator(sy.A, dtype=torch.float64, device=device)
    M = smoothed_aggregation_setup(sy.A, dtype=torch.float64, device=device)
    t_setup = time.perf_counter() - t0
    b = A.put_vector(sy.b, dtype=torch.float64)

    def solve():
        return cg_solve(A, b, torch.zeros_like(b), precond=M, tol=tol,
                        maxiter=1000)

    res, counts, t_solve = _run_counted(kernels, solve)
    check(res.converged, f"CG+AMG did not converge ({res.iterations})")
    levels = [(lvl.n_rows, type(lvl.A).__name__) for lvl in M.levels]
    return A.get_vector(res.x), res, counts, dict(
        setup_s=t_setup, solve_s=t_solve, operator=type(A).__name__,
        levels=levels), (solve, counts), (A, M)


def phase_f4(device, kernels, box: int = BOX) -> dict:
    """P1 FEM with Dirichlet u = 5 on x = 0 and a flux boundary on x = 1:
    Neumann g = 3.25, then Robin (alpha, u_env) = (2, 11); exact linear."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.io import NodeSet, box_mesh
    from domain_decomposed_pde_solver_tpu_torch.models import (
        assemble_poisson_fem,
    )

    t0 = time.perf_counter()
    mesh = box_mesh(box, box, box, "TETRA4")
    x0 = np.nonzero(np.isclose(mesh.coords[:, 0], 0.0))[0].astype(np.int64)
    mesh.node_sets = [NodeSet(id=5, nodes=x0)]
    mesh.side_sets = [_plane_sideset(mesh, 77, 1.0)]
    t_mesh = time.perf_counter() - t0
    g, alpha, u_env = 3.25, 2.0, 11.0
    replays = {}
    cases = {"neumann": (dict(neumann={77: g}), g),
             "robin": (dict(robin={77: (alpha, u_env)}),
                       alpha * (u_env - 5.0) / (1.0 + alpha))}
    out, errs = {}, {}
    for label, (kw, slope) in cases.items():
        t0 = time.perf_counter()
        sy = assemble_poisson_fem(mesh, **kw)
        t_asm = time.perf_counter() - t0
        u, res, counts, times, replays[f"F4 {label}"], ops = _fem_solve(
            device, kernels, sy, tol=1e-13)
        err = float(np.abs(u - (5.0 + slope * mesh.coords[sy.free_to_node, 0])
                           ).max())
        log(f"[F4] P1 {label} on box_mesh({box}^3), {sy.n_free} DOF, "
            f"{sy.A.nnz} nnz: assembly {t_asm:.2f} s (mesh and sideset "
            f"{t_mesh:.2f} s), operator {times['operator']}, AMG "
            f"{times['levels']}, set-up {times['setup_s']:.2f} s; CG+AMG to "
            f"1e-13: {res.iterations} iterations in {times['solve_s']:.3f} s; "
            f"max |u - (5 + {slope:g} x)| = {err:.3e} (limit 1e-6); launches "
            f"{_launched(counts)}")
        check(err <= 1e-6, f"[F4] {label}: error {err:.3e} > 1e-6")
        _want_launched(device, counts, ["dia_spmv"], "F4")
        operator_compare(device, errs, f"P1 {label}", *ops, tag="F4")
        out[label] = dict(dof=sy.n_free, iterations=res.iterations,
                          max_err=err, assembly_s=t_asm, launches=counts,
                          **times)
    out["replays"], out["errs"] = replays, errs
    return out


def _u_p2(c):
    return c[:, 0] ** 2 + 2 * c[:, 1] ** 2 - 3 * c[:, 2] ** 2


def _u_q2(c):
    return c[:, 0] ** 2 + 2 * c[:, 1] ** 2 + 3 * c[:, 2] ** 2 - c[:, 0] * c[:, 1]


def phase_f5(device, kernels, cells: int = QUAD_CELLS) -> dict:
    """P2 on a TETRA4 box and Q2 on a HEX8 box against their manufactured
    quadratics (JAX's tests/test_p2.py:42 and tests/test_q2.py:51)."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
    from domain_decomposed_pde_solver_tpu_torch.models import (
        assemble_poisson_p2,
        assemble_poisson_q2,
        elevate_to_p2,
        elevate_to_q2,
    )

    cases = {
        "p2": ("TETRA4", assemble_poisson_p2, elevate_to_p2,
               dict(dirichlet=_u_p2)),
        "q2": ("HEX8", assemble_poisson_q2, elevate_to_q2,
               dict(dirichlet=_u_q2, f=lambda c: np.full(c.shape[0], -12.0))),
    }
    out, replays, errs = {}, {}, {}
    for label, (elem, assemble, elevate, kw) in cases.items():
        mesh = box_mesh(cells, cells, cells, elem)
        t0 = time.perf_counter()
        sy = assemble(mesh, **kw)
        t_asm = time.perf_counter() - t0
        coords = elevate(mesh)[0]
        u, res, counts, times, replays[f"F5 {label}"], ops = _fem_solve(
            device, kernels, sy, tol=1e-13)
        err = float(np.abs(u - kw["dirichlet"](coords[sy.free_to_node])).max())
        log(f"[F5] {label.upper()} on box_mesh({cells}^3, {elem}), "
            f"{coords.shape[0]} nodes, {sy.n_free} DOF, {sy.A.nnz} nnz: "
            f"assembly {t_asm:.2f} s, operator {times['operator']}, AMG "
            f"{times['levels']}, set-up {times['setup_s']:.2f} s; CG+AMG to "
            f"1e-13: {res.iterations} iterations in {times['solve_s']:.3f} s; "
            f"max error against the quadratic {err:.3e} (limit 1e-8); "
            f"launches {_launched(counts)}")
        check(err <= 1e-8, f"[F5] {label}: error {err:.3e} > 1e-8")
        _want_launched(device, counts, ["sell_spmv"], "F5")
        operator_compare(device, errs, label.upper(), *ops, tag="F5")
        out[label] = dict(nodes=int(coords.shape[0]), dof=sy.n_free,
                          nnz=sy.A.nnz, iterations=res.iterations,
                          max_err=err, assembly_s=t_asm, launches=counts,
                          **times)
    out["replays"], out["errs"] = replays, errs
    return out


def phase_f6(exo, out=OUT) -> dict:
    """The reference's other three drivers on a small box, host only."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.cli import (
        assemble_test,
        combine,
        decompose,
    )
    from domain_decomposed_pde_solver_tpu_torch.io import read_exodus
    from domain_decomposed_pde_solver_tpu_torch.models import (
        assemble_heat_system,
    )
    from domain_decomposed_pde_solver_tpu_torch.utils import (
        print_csr_matrix,
        print_vector,
    )

    dec = out / "f6_decomposed.exo"
    rc_dec, _t = _captured(lambda: decompose.main(
        ["--input", str(exo), "--output", str(dec), "--partitions", "4"]))
    blocks = len(read_exodus(str(dec)).blocks)
    rc_asm, text_asm = _captured(lambda: assemble_test.main(
        ["--input", str(exo), "--verbose"]))
    sy = assemble_heat_system(read_exodus(str(exo)))
    prefix = str(out / "f6-proc-")
    for p in out.glob("f6-proc-*.out"):
        p.unlink()
    parts = np.arange(sy.n_free) % 2
    print_csr_matrix(sy.A, "Laplacian: A", prefix, parts=parts, nparts=2)
    print_vector(sy.b, "RHS: B", prefix, parts=parts, nparts=2)
    merged = out / "f6_combined.out"
    rc_comb, _t = _captured(lambda: combine.main(
        ["--prefix", prefix, "--output", str(merged)]))
    lines = merged.read_text().splitlines()
    log(f"[F6] decompose rc {rc_dec} ({blocks} blocks), assemble_test rc "
        f"{rc_asm}, combine rc {rc_comb} ({len(lines)} lines for "
        f"{sy.n_free} rows)")
    check(rc_dec == 0 and blocks == 4, "[F6] decompose failed")
    check(rc_asm == 0 and text_asm.strip().endswith("OK"),
          "[F6] assemble_test failed")
    check(rc_comb == 0 and len(lines) == 2 + 2 * sy.n_free,
          "[F6] combine failed")
    return dict(decompose_blocks=blocks, rc=[rc_dec, rc_asm, rc_comb])


def phase_f(device, kernels, system, exo, box: int = BOX,
            small_box: int = SMALL_BOX, quad_cells: int = QUAD_CELLS,
            out=OUT) -> dict:
    """F1-F6 in order; ``system`` is the heat system of ``exo`` (path A's
    1M box).  ``replays`` holds, per counted solve, a function that runs it
    again and the launch counts of its run, for :func:`time_phase_f`;
    ``errs`` the largest absolute difference of each kernel from its plain
    version on F4's and F5's operators (launches not counted)."""
    t0 = time.perf_counter()
    f1 = phase_f1(device, kernels, system)
    f2 = phase_f2(device, kernels, system, f1.pop("A"), small_box, out)
    f3 = phase_f3(device, kernels, exo, system.mesh.num_nodes)
    f4 = phase_f4(device, kernels, box)
    f5 = phase_f5(device, kernels, quad_cells)
    f6 = phase_f6(out / f"f2_box{small_box}.exo", out)
    wall = time.perf_counter() - t0
    log(f"[F] wall {wall:.1f} s")
    replays, errs = {}, {}
    for f in (f1, f2, f3, f4, f5):
        replays.update(f.pop("replays"))
    for f in (f4, f5):
        for key, e in f.pop("errs").items():
            errs[key] = max(errs.get(key, 0.0), e)
    return dict(F1=f1, F2=f2, F3=f3, F4=f4, F5=f5, F6=f6, wall_s=wall,
                replays=replays, errs=errs)


def phase_f_process(result: str) -> int:
    """Phase F in a process of its own (``python3 chip_smoke.py --phase-f
    RESULT``, started by :func:`run_phase_f`): load the kernels the parent
    built, assemble path A's system from its Exodus file, run F1-F6 with
    the launch counters at 0 before each counted run, profile each counted
    solve again (:func:`time_phase_f`) and write the record to ``RESULT``
    as JSON.  Its own process, because the profiler (CUPTI) of a process
    that has run phase F loses device records: a 20-launch trace of one
    product held all 20 before phase F, 12-19 after it, and phase E's
    traces of path B none at all (NVIDIA H100 80GB HBM3, 700 W)."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch.io import read_exodus
    from domain_decomposed_pde_solver_tpu_torch.models import (
        assemble_heat_system,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = _kernels.build_kernels()
    exo = OUT / f"box{BOX}.exo"
    sy = assemble_heat_system(read_exodus(str(exo)))
    run = phase_f(torch.device("cuda", 0), kernels, sy, exo)
    run["times"] = time_phase_f(card_line(), run.pop("replays"))
    pathlib.Path(result).write_text(json.dumps(run))
    return 0


def run_phase_f(timeout: float = 900.0) -> dict:
    """Run :func:`phase_f_process` in a child process on the same card and
    return its record; fails if the child does."""
    result = OUT / "phase_f.json"
    result.unlink(missing_ok=True)
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, str(pathlib.Path(__file__)),
                           "--phase-f", str(result)], cwd=REPO,
                          timeout=timeout)
    check(proc.returncode == 0 and result.exists(),
          f"[F] the phase F process exited with {proc.returncode}")
    return json.loads(result.read_text())


def phase_f_launches(run_f: dict, name: str) -> dict:
    """One kernel's launches in each counted run of phase F."""
    runs = {f"F1 {k}": c for k, c in run_f["F1"]["launches"].items()}
    runs.update({f"F2 {k}": c for k, c in run_f["F2"]["launches"].items()})
    runs["F3"] = run_f["F3"]["launches"]
    for sub in ("F4", "F5"):
        runs.update({f"{sub} {k}": r["launches"]
                     for k, r in run_f[sub].items()})
    return {k: c[name]["launches"] for k, c in runs.items()}


# ---------------------------------------------------------------------------
# G. The BASELINE's 10M box: scan-free structured assembly, brick AMG over
#    the pad-stencil operator, refinement to 1e-8 (bench10m.py's route)
# ---------------------------------------------------------------------------

G_BOX = 217  # bench10m.py's N: free grid 216 x 218 x 218, 10,265,184 DOF
G_SWEEPS = (2, 3)  # JAX's record of this route (BENCH10M.json): 2 sweeps


def phase_g(device, kernels, n: int = G_BOX) -> dict:
    """``bench10m.py:95-230`` through the port's public functions at
    ``box_mesh(n, n, n, "TETRA4")``'s size: ``structured_box_system`` (one
    native pass, no mesh), ``structured_box_parts`` built on ``device``,
    ``pad_stencil_from_parts`` (kernel 3), brick AMG with the pad-stencil
    level 0, a DIA level 1 (kernel 4) and, at full size, sliced-ELL levels
    below it (kernel 1), CG+AMG to 1e-6 in f32, then
    ``iterative_refinement_solve`` to 1e-8 with the staged f64 right-hand
    side and the f64 residual on the card.  The launch counters are 0
    just before the two solves and read just after.  Checks: the
    device-built b and degree equal the assembled ones; both solves
    converge; the host f64 relres of the refined answer <= 1.5e-8 (one
    SciPy product over the CSR); G_SWEEPS sweeps; every value within
    [100, 1000]; on the card, kernel 3 in f32 and f64, kernel 4 and (for
    sliced-ELL levels) kernel 1 ran."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.models.structured import (
        structured_box_parts,
        structured_box_system,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import DIAMatrix
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        PadStencilOperator,
        pad_stencil_from_parts,
    )
    from domain_decomposed_pde_solver_tpu_torch.solvers import (
        cg_solve,
        smoothed_aggregation_setup,
    )
    from domain_decomposed_pde_solver_tpu_torch.solvers.mixed import (
        iterative_refinement_solve,
    )

    times = {}
    t0 = time.perf_counter()
    sy = structured_box_system(n, n, n, "TETRA4")
    times["assembly_s"] = time.perf_counter() - t0
    check(sy.mesh is None, "[G] structured_box_system took the mesh path")
    nf, dims = sy.n_free, (n - 1, n + 1, n + 1)
    t0 = time.perf_counter()
    po = structured_box_parts(n, n, n, "TETRA4", device=device)
    sync(device)
    times["parts_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = pad_stencil_from_parts(po["parts"], device=device)
    sync(device)
    times["operator_s"] = time.perf_counter() - t0
    check(np.array_equal(po["b"][:nf].cpu().numpy(), sy.b.astype(np.float32))
          and np.array_equal(po["degree"][:nf].cpu().numpy(),
                             sy.degree.astype(np.float32)),
          "[G] the device-built b or degree differs from the assembled one")
    del po
    log(f"[G] box_mesh({n}^3) TETRA4: {nf} free DOF, {sy.A.nnz} nnz, free "
        f"grid {dims}, padded space (Z, myp, mxp) = ({A.Z}, {A.myp}, "
        f"{A.mxp}), {A.n_pad} slots, correction in {str(A.corr.dtype)[6:]}; "
        f"assembly {times['assembly_s']:.2f} s, parts on {device} "
        f"{times['parts_s']:.2f} s, operator {times['operator_s']:.2f} s")
    ph = {}
    t0 = time.perf_counter()
    M = smoothed_aggregation_setup(sy.A, dtype=torch.float32, grid_dims=dims,
                                   fine_operator=A, timings_out=ph,
                                   device=device)
    sync(device)
    times["amg_setup_s"] = time.perf_counter() - t0
    times["amg_setup_phases_s"] = ph
    levels = [dict(rows=lvl.n_rows, operator=type(lvl.A).__name__,
                   transfer=type(lvl.P).__name__,
                   diagonals=getattr(lvl.A, "ndiags", None),
                   n_pad=lvl.A.n_pad) for lvl in M.levels]
    log(f"[G] AMG set-up {times['amg_setup_s']:.2f} s, phases "
        f"{json.dumps({k: round(v, 3) for k, v in ph.items()})}; levels "
        f"{json.dumps(levels)} + coarse {tuple(M.coarse_inv.shape)}")
    check(isinstance(M.levels[0].A, PadStencilOperator)
          and levels[0]["transfer"] == "PadBrickProlongator",
          f"[G] level 0 is {levels[0]}")
    check(len(M.levels) >= 2 and isinstance(M.levels[1].A, DIAMatrix),
          f"[G] level 1 is not DIA: {levels}")

    bscale = float(np.abs(sy.b).max())
    b = A.put_vector_sparse((sy.b / bscale).astype(np.float32))
    zero = torch.zeros_like(b)
    b64 = np.asarray(sy.b, dtype=np.float64)
    b64dev = A.put_vector_sparse(b64, dtype=torch.float64)

    def cg():
        return cg_solve(A, b, zero, precond=M, tol=1e-6, maxiter=100)

    def refine():
        return iterative_refinement_solve(
            sy.A, b64, tol=1e-8, inner_tol=1e-6, inner_maxiter=100,
            precond=M, operator=A, b_device=b64dev, device_residual=True)

    reset_counts(kernels)
    t0 = time.perf_counter()
    r, d_cg = launch_delta(kernels, cg)
    times["cg_first_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mr, d_ref = launch_delta(kernels, refine)
    times["refine_first_s"] = time.perf_counter() - t0
    counts = read_counts(kernels)
    times["cg_ms"] = _wall_ms(cg, 2)
    times["refine_ms"] = _wall_ms(refine, 2)
    u = mr.x
    t0 = time.perf_counter()
    rr = host_relres(sy.A, u, b64)
    times["host_check_s"] = time.perf_counter() - t0
    log(f"[G] CG+AMG to 1e-6 (f32): {r.iterations} iterations, relres "
        f"{r.relres:.3e}, first {times['cg_first_s']:.3f} s, warm "
        f"{times['cg_ms']} ms; launches {json.dumps(d_cg)}")
    log(f"[G] refinement to 1e-8: {mr.refinements} sweeps, "
        f"{mr.inner_iterations} inner iterations, relres {mr.relres:.3e}, "
        f"timings {json.dumps(mr.timings)}, first "
        f"{times['refine_first_s']:.3f} s, warm {times['refine_ms']} ms; "
        f"host f64 relres {rr:.3e} (limit 1.5e-8, {times['host_check_s']:.2f}"
        f" s); values [{float(u.min())}, {float(u.max())}]; launches "
        f"{json.dumps(d_ref)}")
    log(f"[G] launches by entry: {_launched(counts)}")
    check(r.converged, "[G] CG+AMG to 1e-6 did not converge")
    check(mr.converged, "[G] the refinement did not converge")
    check(rr <= 1.5e-8, f"[G] host relres {rr:.3e} > 1.5e-8")
    check(G_SWEEPS[0] <= mr.refinements <= G_SWEEPS[1],
          f"[G] {mr.refinements} sweeps, not within {G_SWEEPS}")
    check(u.shape == (nf,) and bool(np.isfinite(u).all()),
          "[G] the answer has another shape or non-finite values")
    check(100.0 <= float(u.min()) and float(u.max()) <= 1000.0,
          f"[G] values [{u.min()}, {u.max()}] outside [100, 1000]")
    if device.type == "cuda":
        by = counts["pad_stencil"]["by_entry"]
        check(any(k.startswith("ddps_pad_stencil_f32") for k in by)
              and any(k.startswith("ddps_pad_stencil_f64") for k in by),
              f"[G] kernel 3 did not run in f32 and f64: {by}")
        check(counts["dia_spmv"]["launches"] > 0, "[G] kernel 4 did not run")
        sell = any(lvl["operator"] == "BSGMatrix" for lvl in levels)
        check(not sell or counts["sell_spmv"]["launches"] > 0,
              "[G] kernel 1 did not run on the sliced-ELL levels")
    return dict(sy=sy, A=A, M=M, b=b, cg=r, refine=mr, counts=counts,
                launches=dict(cg=d_cg, refine=d_ref), host_relres=rr,
                times=times, levels=levels,
                u_range=(float(u.min()), float(u.max())),
                replays={"G cg": (cg, d_cg), "G refine": (refine, d_ref)})


def compare_phase_g(device, run_g) -> dict:
    """Kernel 3 in f32 and f64 on the 10M operator, kernel 4 on every DIA
    level of its hierarchy (at every compiled instance and block of the
    shape, bit-identical to the default launch) and kernel 1 on every
    sliced-ELL level, against their plain versions; these launches do not
    count.  Returns the errors."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import DIAMatrix

    rng = np.random.default_rng(7)
    errs = {}
    A, sy = run_g["A"], run_g["sy"]
    mask = A.pad_mask() == 0
    for name, tol in (("float32", TOL_F32), ("float64", TOL_F64)):
        x = A.put_vector(rng.normal(size=sy.n_free), dtype=getattr(torch, name))
        _compare(f"pad-stencil 10M box, dims {A.dims}, (Z, myp, mxp) = "
                 f"({A.Z}, {A.myp}, {A.mxp}) ({name} vectors)", A.matvec(x),
                 A.matvec_reference(x), tol, errs, "pad_stencil", mask,
                 tag="G")
        del x
    for i, lvl in enumerate(run_g["M"].levels[1:], 1):
        D = lvl.A
        if not isinstance(D, DIAMatrix):
            for name, tol in (("float32", TOL_F32), ("float64", TOL_F64)):
                sell_compare(device, rng, errs, f"level {i} of the 10M box",
                             D, tol, tag="G", dtype=getattr(torch, name))
            continue
        shape = _kernels.dia_launch_shape(D.n_pad, D.ndiags)
        log(f"[G] level {i}: {D.n_rows} rows, {D.ndiags} diagonals, "
            f"{str(D.data.dtype)[6:]} storage: kernel 4 takes {shape}")
        for name, tol in (("float32", TOL_F32), ("float64", TOL_F64)):
            dia_compare(device, rng, errs, f"level {i} of the 10M box", D,
                        name, tol, tag="G")
    return errs


def time_phase_g(device, card, run_g) -> dict:
    """Phase G on the card: each counted solve again under the profiler
    (device time, busy time, wall, idle share, the port's kernels);
    kernel 3 on the 10M operator at every z-depth, with L2 flushed, in
    f64, beside its plain version, cuSPARSE on the CSR and its bound (the
    10M space of phase E, now the real operator); kernel 4 on level 1
    beside its plain version, launch floor and bound."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
    from domain_decomposed_pde_solver_tpu_torch.ops.dia_kernel import (
        dia_matvec_plain,
    )

    out = {}
    for label, (fn, d) in run_g["replays"].items():
        per = {k: v for k, v in d.items() if v}
        p = profile_device(fn, reps=1, kernel="pad_stencil_kernel",
                           per_call=per.get("pad_stencil", 0))
        rec = dict(replay_record(p),
                   port_kernels={k[:80]: v for k, v in p["kernels"].items()
                                 if "pad_stencil_kernel" in k
                                 or "dia_spmv_kernel" in k})
        log(f"[G] {label}: {replay_text(rec)}; port kernels (launches, ms) "
            f"{json.dumps(rec['port_kernels'])} [{card}]")
        out[label] = rec
    A, sy = run_g["A"], run_g["sy"]
    rng = np.random.default_rng(8)
    scrub = torch.empty(64 * 2**20, dtype=torch.float32, device=device)
    out["pad_depths"] = time_pad_depths(device, card, {"10M": A}, rng, scrub)
    S = sy.A
    k3 = {}
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        x = A.put_vector(rng.normal(size=sy.n_free), dtype=dt)
        xi = A.extract_device(x).contiguous()
        Acsr = _csr_tensor(S.indptr, S.indices, S.data, S.shape[1], dt, device)
        t = _measure({"kernel": lambda: A.matvec(x),
                      "plain": lambda: A.matvec_reference(x),
                      "library": lambda: Acsr @ xi}, reps=20)
        b_ms, b_by, nbytes = _pad_bound(A, x)
        k3[name] = dict(ms=t["kernel"]["device_ms"],
                        plain_ms=t["plain"]["device_ms"],
                        library_ms=t["library"]["device_ms"], bound_ms=b_ms,
                        bound_by=b_by)
        log(f"[G] kernel 3 on the 10M operator ({name} vectors): device ms "
            f"per call kernel {t['kernel']['device_ms']}, plain "
            f"{t['plain']['device_ms']}, cuSPARSE CSR ({S.nnz} nnz) "
            f"{t['library']['device_ms']}; bound {b_ms} ms by {b_by} "
            f"({nbytes / 1e6:.2f} MB) [{card}]")
        del Acsr, x, xi
    out["pad_stencil"] = k3
    D = run_g["M"].levels[1].A
    x = torch.as_tensor(rng.normal(size=D.n_pad), dtype=torch.float32,
                        device=device)
    shape = _kernels.dia_launch_shape(D.n_pad, D.ndiags)
    t = _measure({"kernel": lambda: D.matvec(x),
                  "plain": lambda: dia_matvec_plain(D, x)})
    floor = profile_device(lambda: _kernels.dia_floor_launch(
        "noop", x, shape))["device_ms"]
    nbytes = D.ndiags * D.n_pad * D.data.element_size() + 2 * D.n_pad * 4
    b_ms, b_by = bound(nbytes, 2 * D.ndiags * D.n_pad)
    log(f"[G] kernel 4 on level 1 ({D.n_rows} rows, {D.ndiags} diagonals, "
        f"{shape}): device ms per call kernel {t['kernel']['device_ms']}, "
        f"plain {t['plain']['device_ms']}, launch floor {floor}; bound "
        f"{b_ms} ms by {b_by} [{card}]")
    out["dia_level1"] = dict(ms=t["kernel"]["device_ms"],
                             plain_ms=t["plain"]["device_ms"],
                             launch_floor_ms=floor, bound_ms=b_ms,
                             bound_by=b_by, rows=D.n_rows,
                             diagonals=D.ndiags, instance=shape.instance,
                             block=shape.block)
    return out


def phase_g_record(run_g) -> dict:
    """What the smoke's record keeps of phase G (numbers only)."""
    sy, A, mr, r = run_g["sy"], run_g["A"], run_g["refine"], run_g["cg"]
    return dict(dof=sy.n_free, nnz=int(sy.A.nnz), dims=list(A.dims),
                padded=[A.Z, A.myp, A.mxp], n_pad=A.n_pad,
                levels=run_g["levels"], times=run_g["times"],
                cg=dict(iterations=r.iterations, relres=r.relres),
                refine=dict(sweeps=mr.refinements,
                            inner_iterations=mr.inner_iterations,
                            relres=mr.relres, timings=mr.timings),
                host_relres=run_g["host_relres"], u_range=run_g["u_range"],
                launches=run_g["launches"], counts=run_g["counts"])


def phase_g_process(result: str) -> int:
    """Phase G in a process of its own (``python3 chip_smoke.py --phase-g
    RESULT``, started by :func:`run_phase_g`), as phase F: load the
    kernels the parent built, run :func:`phase_g`, its comparisons and its
    timing, and write the record to ``RESULT`` as JSON."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = _kernels.build_kernels()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    run = phase_g(device, kernels)
    rec = phase_g_record(run)
    rec["errs"] = compare_phase_g(device, run)
    rec["timing"] = time_phase_g(device, card_line(), run)
    rec["wall_s"] = time.perf_counter() - t0
    pathlib.Path(result).write_text(json.dumps(rec))
    return 0


def run_phase_g(timeout: float = 900.0) -> dict:
    """Run :func:`phase_g_process` in a child process on the same card and
    return its record; fails if the child does."""
    result = OUT / "phase_g.json"
    result.unlink(missing_ok=True)
    OUT.mkdir(parents=True, exist_ok=True)
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, str(pathlib.Path(__file__)),
                           "--phase-g", str(result)], cwd=REPO,
                          timeout=timeout)
    check(proc.returncode == 0 and result.exists(),
          f"[G] the phase G process exited with {proc.returncode}")
    return json.loads(result.read_text())


# ---------------------------------------------------------------------------
# H. The domain-decomposed solve: halo plans, partitioned CG/GMRES/power,
#    the global halo AMG, block-Schwarz AMG and ILUT, the CLI's --partitions
# ---------------------------------------------------------------------------

H_PARTS = (4, 8)
H_SEED = 0  # the CLI's x0: default_rng(seed).uniform(-1, 1)
H_BLOCK_COARSE = 1024  # block AMG's coarse_size when JAX's 64 falls back


def _cli_x0(n: int):
    import numpy as np

    return np.random.default_rng(H_SEED).uniform(-1.0, 1.0, size=n)


def _partition(sy, nparts: int, dtype="float32") -> tuple:
    """The CLI's partition of the free-node graph and its halo plan (values
    in ``dtype``), with the host seconds of each."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.ops.csr import coo_to_csr
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        build_halo_plan,
        partition_graph,
    )

    A = sy.A
    t0 = time.perf_counter()
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    off = rows != A.indices
    adj = coo_to_csr(rows[off], A.indices[off], np.ones(int(off.sum())),
                     A.shape, sum_dups=False)
    parts = partition_graph(adj, nparts,
                            coords=sy.mesh.coords[sy.free_to_node])
    t_part = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = build_halo_plan(A, parts, nparts, dtype=np.dtype(dtype))
    return plan, t_part, time.perf_counter() - t0


def phase_h1(device, kernels, refs, cells: int = MESH_CELLS,
             out=OUT) -> dict:
    """The CLI's halo route with the global AMG on path C's mesh, written
    as Exodus: ``--partitions 4 --precond amg --dtype float32 --tolerance
    1e-6 --no-snapshots``."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.cli.solve import main
    from domain_decomposed_pde_solver_tpu_torch.io import (
        box_mesh,
        read_nodal_vars,
        refine_uniform,
        write_exodus,
    )

    out.mkdir(parents=True, exist_ok=True)
    exo, sol = out / f"h1_refined{cells}.exo", out / "h1_solution.exo"
    t0 = time.perf_counter()
    write_exodus(str(exo), refine_uniform(box_mesh(cells, cells, cells,
                                                   "TETRA4"), 1))
    t_mesh = time.perf_counter() - t0
    args = ["--input", exo, "--solution", sol, "--partitions", 4,
            "--precond", "amg", "--dtype", "float32", "--tolerance", 1e-6,
            "--no-snapshots", "--verbose"]
    args += [] if device.type == "cuda" else ["--cpu"]
    rep = {}
    (rc, text), counts, wall = _run_counted(
        kernels, lambda: _captured(lambda: main([str(a) for a in args],
                                                report=rep)))
    sy, res, hamg = rep["system"], rep["result"], rep["precond"]
    _names, _times, vals = read_nodal_vars(str(sol))
    u = vals[-1, 0, sy.free_to_node]
    rr = host_relres(sy.A, u, sy.b)
    phases = rep["timer"].as_dict()
    log(f"[H1] CLI --partitions 4 --precond amg on {sy.n_free} DOF: rc {rc},"
        f" {res.iterations} iterations (path C: {refs.get('c_iterations')}),"
        f" relres {res.relres:.3e}, host f64 relres {rr:.3e}, values "
        f"[{u.min():.6g}, {u.max():.6g}]; wall {wall:.1f} s (mesh written "
        f"in {t_mesh:.1f} s); phases {json.dumps(phases)}; launches "
        f"{_launched(counts)}")
    check(rc == 0 and res.converged, f"[H1] the CLI exited with {rc}")
    check(type(rep["operator"]).__name__ == "ShardedOperator"
          and type(hamg).__name__ == "HaloAMG",
          f"[H1] operator {type(rep['operator']).__name__}, preconditioner "
          f"{type(hamg).__name__}")
    if "c_iterations" in refs:
        check(abs(res.iterations - refs["c_iterations"]) <= 2,
              f"[H1] {res.iterations} iterations vs path C's "
              f"{refs['c_iterations']}")
    check(rr <= 2e-6, f"[H1] host relres {rr:.3e} > 2e-6")
    check(bool(np.isfinite(u).all()) and 100.0 <= float(u.min())
          and float(u.max()) <= 1000.0,
          f"[H1] values [{u.min()}, {u.max()}] outside [100, 1000]")
    _want_launched(device, counts, ["sell_spmv"], "H1")
    tail = [type(lvl.A).__name__ for lvl in hamg.tail.levels]
    return dict(system=sy, plan=rep["plan"], op=rep["operator"], hamg=hamg,
                iterations=res.iterations, relres=res.relres,
                host_relres=rr, phases_s=phases, cli_wall_s=wall,
                mesh_s=t_mesh, launches=counts, tail_levels=tail,
                n_c=hamg.n_c)


def _per_part_ms(op, x, launches, reps: int = 20,
                 kernel: str = "sell_spmv_kernel", attempts: int = 5) -> list:
    """Device ms of each part's launch of ``kernel`` (kernel 1 by default)
    in ``op.matvec(x)``, from the profiler (the launches of one product
    come in part order).  A trace that lacks some of the launches is taken
    again, up to ``attempts`` times; then ``launches`` (one callable per
    part, launching that part's kernel alone) are timed by CUDA events
    instead, back to back (device time plus the gaps between launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    P_ = op.nparts
    op.matvec(x)
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                op.matvec(x)
            torch.cuda.synchronize()
        ev = sorted((s, t) for n, s, t in _device_events(prof)
                    if kernel in n)
        if len(ev) == reps * P_:
            return [sum(t - s for s, t in ev[p::P_]) / 1e3 / reps
                    for p in range(P_)]
        log(f"profiler: per-part trace {attempt + 1} held {len(ev)} launches")
        time.sleep(0.5)
    log(f"profiler: no whole per-part trace in {attempts}; CUDA events "
        f"around each part's launch instead")
    return [time_ms(fn, reps) for fn in launches]


def _h2_kernel_checks(device, op, errs, tag):
    """Every part's kernel-1 launch against its plain version (f32,
    relative 1e-6), the halo rows exactly 0, and the bf16 storage
    bit-identical to a float32-storage launch of the same values.  Adds
    the largest absolute difference to ``errs``; returns the input and
    that difference."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import (
        bsg_spmv,
        spmv_plain,
    )

    rng = np.random.default_rng(17)
    x = torch.as_tensor(rng.normal(size=(op.nparts, op.n_local)),
                        dtype=torch.float32, device=device)
    xe = op.extended(x)
    n = op.n_local
    rows = np.arange(op.parts[0].n_pad)
    mine = {}
    for p, blk in enumerate(op.parts):
        y = bsg_spmv(blk, xe[p])
        mask = torch.as_tensor(rows >= n, device=device)
        _compare(f"part {p} of {op.nparts} ({blk.n_pad} rows, {blk.n_slots} "
                 f"slots, {blk.storage})", y, spmv_plain(blk, xe[p]), 1e-6,
                 mine, "sell_spmv", mask=mask, tag=tag)
        y32 = bsg_spmv(with_storage(blk, torch.float32), xe[p])
        check(torch.equal(y, y32), f"[{tag}] part {p}: {blk.storage} storage "
              "is not bit-identical to float32 storage")
    errs["sell_spmv"] = max(errs.get("sell_spmv", 0.0), mine["sell_spmv"])
    return x, mine["sell_spmv"]


def phase_h2(device, kernels, refs, run_h1, parts=H_PARTS) -> dict:
    """The API on H1's system with :class:`BSGShardedOperator` (kernel 1
    per part): Jacobi-CG to 1e-6 at every P, CG with H1's halo AMG over
    the sliced-ELL blocks and block-Schwarz AMG with and without the
    two-level coarse correction at the first P; each part's product
    against its plain version."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        BSGShardedOperator,
        build_block_amg,
        halo_amg_cg_solve,
        make_device_mesh,
        sharded_cg_solve,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel.schwarz import (
        build_coarse_correction,
    )

    sy = run_h1["system"]
    deg = np.where(sy.degree > 0, sy.degree, 1.0)
    x0_cli = _cli_x0(sy.n_free)
    out, errs, replays = {}, {}, {}
    for P_ in parts:
        if P_ == run_h1["plan"].nparts:
            plan, t_part, t_plan = run_h1["plan"], None, None
        else:
            plan, t_part, t_plan = _partition(sy, P_)
        t0 = time.perf_counter()
        op = BSGShardedOperator.from_plan(plan, make_device_mesh(P_,
                                                                 [device]))
        sync(device)
        t_op = time.perf_counter() - t0
        b = op.put_vector(sy.b)
        inv_d = op.put_vector(1.0 / deg)

        def jacobi(op=op, b=b, inv_d=inv_d):
            return sharded_cg_solve(op, b, torch.zeros_like(b),
                                    precond_diag=inv_d, tol=PCG_TOL,
                                    maxiter=PCG_MAXITER)

        rj, counts, wall = _run_counted(kernels, jacobi)
        u = op.get_vector(rj.x)
        rr = host_relres(sy.A, u, sy.b)
        limit = 5e-6 + refs.get("d1_floor", f32_floor(sy.A, u, sy.b))
        launches = counts["sell_spmv"]["launches"]
        rec = dict(n_local=plan.n_local, halo_width=plan.halo_width,
                   n_pad=op.parts[0].n_pad, storage=op.parts[0].storage,
                   slots=[blk.n_slots for blk in op.parts],
                   partition_s=t_part, plan_s=t_plan, operator_s=t_op,
                   jacobi=dict(iterations=rj.iterations, relres=rj.relres,
                               host_relres=rr, limit=limit, wall_s=wall,
                               launches=counts))
        log(f"[H2] P={P_}: n_local {plan.n_local}, halo width "
            f"{plan.halo_width}, blocks of {op.parts[0].n_pad} rows "
            f"({op.parts[0].storage}); partition {t_part} s, plan {t_plan} "
            f"s, operator {t_op:.2f} s; Jacobi-CG {rj.iterations} iterations"
            f" (D1 unfused: {refs.get('d1_iterations')}), host relres "
            f"{rr:.3e} (limit {limit:.3e}), {wall:.2f} s, kernel-1 launches "
            f"{launches}")
        check(rj.converged, f"[H2] P={P_}: Jacobi-CG did not converge")
        if "d1_iterations" in refs:
            check(abs(rj.iterations - refs["d1_iterations"]) <= 2,
                  f"[H2] P={P_}: {rj.iterations} iterations vs D1's "
                  f"{refs['d1_iterations']}")
        check(rr <= limit, f"[H2] P={P_}: host relres {rr:.3e}")
        if device.type == "cuda":
            # One launch per part per product: the initial residual and one
            # product per iteration.
            check(launches == P_ * (rj.iterations + 1),
                  f"[H2] P={P_}: {launches} kernel-1 launches, want "
                  f"{P_ * (rj.iterations + 1)}")
        replays[f"H2 jacobi P={P_}"] = (jacobi, counts)
        if P_ == parts[0]:
            hamg = run_h1["hamg"]

            def halo(op=op):
                return halo_amg_cg_solve(op, hamg, sy.b.astype(np.float32),
                                         x0_cli.astype(np.float32), tol=1e-6,
                                         maxiter=200)

            (_x, rh), counts_h, wall_h = _run_counted(kernels, halo)
            log(f"[H2] P={P_}: CG with H1's halo AMG over the sliced-ELL "
                f"blocks: {rh.iterations} iterations (H1: "
                f"{run_h1['iterations']}), relres {rh.relres:.3e}, "
                f"{wall_h:.2f} s")
            check(rh.converged and abs(rh.iterations
                                       - run_h1["iterations"]) <= 2,
                  f"[H2] halo AMG over BSG: {rh.iterations} iterations vs "
                  f"H1's {run_h1['iterations']}")
            replays[f"H2 halo-amg P={P_}"] = (halo, counts_h)
            # JAX's defaults (max_levels 4, coarse_size 64) first; a part
            # smaller than n_local keeps its padding rows as isolated unit
            # rows, which no aggregation merges, so its coarsest level can
            # stay above the dense limit (4 * coarse_size) and the build
            # returns None, as JAX's does (its CLI then takes Jacobi).  A
            # larger coarse_size keeps them in the dense coarse solve.
            coarse_size = 64
            t0 = time.perf_counter()
            M = build_block_amg(sy.A, plan, dtype=torch.float32,
                                device=device)
            if M is None:
                coarse_size = H_BLOCK_COARSE
                M = build_block_amg(sy.A, plan, dtype=torch.float32,
                                    coarse_size=coarse_size, device=device)
            t_amg = time.perf_counter() - t0
            pads = [plan.n_local - int(v) for v in plan.row_valid.sum(1)]
            check(M is not None, f"[H2] block AMG fell back to Jacobi with "
                  f"coarse_size {coarse_size} (padding rows per part {pads})")
            log(f"[H2] P={P_}: block AMG with coarse_size {coarse_size} "
                f"(padding rows per part {pads}): levels "
                f"{[[lvl.n_rows for lvl in m.levels] for m in M.parts]}, "
                f"coarse {[tuple(m.coarse_inv.shape) for m in M.parts]}")
            coarse = dict(coarse_inv=build_coarse_correction(
                sy.A, plan, device=device), row_valid=torch.as_tensor(
                plan.row_valid, device=device))
            schwarz = {}
            for label, kw in (("one-level", {}), ("two-level", coarse)):
                rs, counts_s, wall_s = _run_counted(
                    kernels, lambda kw=kw: sharded_cg_solve(
                        op, b, torch.zeros_like(b), block_amg=M, tol=PCG_TOL,
                        maxiter=PCG_MAXITER, **kw))
                rrs = host_relres(sy.A, op.get_vector(rs.x), sy.b)
                log(f"[H2] P={P_}: block-Schwarz AMG {label} ({len(M.parts)}"
                    f" hierarchies of {len(M.parts[0].levels) + 1} levels, "
                    f"set up in {t_amg:.1f} s): {rs.iterations} iterations "
                    f"(Jacobi {rj.iterations}), host relres {rrs:.3e}, "
                    f"{wall_s:.2f} s")
                check(rs.converged and rs.iterations <= rj.iterations,
                      f"[H2] block-Schwarz {label}: {rs.iterations} "
                      f"iterations, converged {rs.converged}")
                check(rrs <= limit, f"[H2] block-Schwarz {label}: host "
                      f"relres {rrs:.3e}")
                schwarz[label] = dict(iterations=rs.iterations,
                                      host_relres=rrs, wall_s=wall_s,
                                      launches=counts_s)
            rec.update(halo_amg=dict(iterations=rh.iterations,
                                     relres=rh.relres, wall_s=wall_h,
                                     launches=counts_h),
                       block_amg_setup_s=t_amg, schwarz=schwarz,
                       block_amg_coarse_size=coarse_size,
                       padding_rows=pads)
        rec["x"], rec["max_abs_err"] = _h2_kernel_checks(device, op, errs,
                                                         f"H2 P={P_}")
        rec["op"] = op
        out[P_] = rec
    return dict(parts=out, errs=errs, replays=replays)


def phase_h3(device, kernels, cells: int = SMALL_CELLS) -> dict:
    """The reference's own configuration over 4 parts: GMRES with per-part
    ILUT (``build_block_ilu``), f64, to 1e-8, beside partitioned Jacobi-
    GMRES and single-device GMRES + Jacobi (JAX's leg 1d)."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.io import (
        box_mesh,
        refine_uniform,
    )
    from domain_decomposed_pde_solver_tpu_torch.models.heat import (
        assemble_heat_system,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import choose_operator
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        ShardedOperator,
        build_block_ilu,
        make_device_mesh,
        sharded_gmres_solve,
    )
    from domain_decomposed_pde_solver_tpu_torch.solvers import (
        gmres_solve,
        jacobi_preconditioner,
    )

    sy = assemble_heat_system(refine_uniform(box_mesh(cells, cells, cells,
                                                      "TETRA4"), 1))
    plan, t_part, _t = _partition(sy, 4, "float64")
    op = ShardedOperator.from_plan(plan, make_device_mesh(4, [device]))
    t0 = time.perf_counter()
    Mi = build_block_ilu(sy.A, plan, dtype=torch.float64, kind="ilut",
                         device=device)
    t_ilut = time.perf_counter() - t0
    check(Mi is not None, "[H3] block ILUT hit a zero pivot")
    b = op.put_vector(sy.b)
    x0 = torch.zeros_like(b)
    deg = np.where(sy.degree > 0, sy.degree, 1.0)
    kw = dict(restart=30, tol=1e-8, maxiter=2000)
    ri, counts, wall = _run_counted(kernels, lambda: sharded_gmres_solve(
        op, b, x0, block_precond=Mi, **kw))
    rj = sharded_gmres_solve(op, b, x0, precond_diag=op.put_vector(1.0 / deg),
                             **kw)
    A1 = choose_operator(sy.A, dtype=torch.float64, device=device)
    b1 = A1.put_vector(sy.b, dtype=torch.float64)
    r1 = gmres_solve(A1, b1, torch.zeros_like(b1),
                     precond=jacobi_preconditioner(A1), **kw)
    rr = host_relres(sy.A, op.get_vector(ri.x), sy.b)
    log(f"[H3] GMRES + per-part ILUT over 4 parts on {sy.n_free} DOF (ILUT "
        f"factors {t_ilut:.1f} s, partition {t_part:.2f} s): "
        f"{ri.iterations} iterations, host relres {rr:.3e}, {wall:.2f} s; "
        f"partitioned Jacobi-GMRES {rj.iterations}, single-device "
        f"GMRES+Jacobi ({type(A1).__name__}) {r1.iterations}")
    check(ri.converged, "[H3] GMRES + block ILUT did not converge")
    check(rr <= 1.5e-8, f"[H3] host relres {rr:.3e} > 1.5e-8")
    check(ri.iterations <= rj.iterations + 2,
          f"[H3] block ILUT {ri.iterations} vs Jacobi {rj.iterations}")
    check(rj.converged and r1.converged
          and abs(rj.iterations - r1.iterations) <= 2,
          f"[H3] partitioned Jacobi-GMRES {rj.iterations} vs single-device "
          f"{r1.iterations}")
    return dict(dof=sy.n_free, iterations=ri.iterations, host_relres=rr,
                jacobi_iterations=rj.iterations,
                single_device_iterations=r1.iterations, ilut_s=t_ilut,
                wall_s=wall, launches=counts)


def phase_h4(device, kernels, exo, f3_eigenvalue=None) -> dict:
    """``cli.matrix_test --partitions 4`` on F3's mesh: the eigenvalue of
    F3's single-device run within 1e-8 relative."""
    from domain_decomposed_pde_solver_tpu_torch.cli.matrix_test import main

    rep = {}
    args = ["--input", str(exo), "--partitions", "4"] + (
        [] if device.type == "cuda" else ["--cpu"])
    (rc, text), counts, wall = _run_counted(
        kernels, lambda: _captured(lambda: main(args, report=rep)))
    res = rep["result"]
    final = text.strip().splitlines()[-1]
    log(f"[H4] matrix test --partitions 4 on {rep['laplacian'].n_rows} rows:"
        f" rc {rc}, {res.iterations} iterations, lambda_max "
        f"{res.eigenvalue:.17g} (F3: {f3_eigenvalue}), wall {wall:.1f} s")
    check(rc == 0 and final.startswith("lambda_max ~= "),
          f"[H4] rc {rc}, final line {final!r}")
    if f3_eigenvalue is not None:
        check(abs(res.eigenvalue - f3_eigenvalue) <= 1e-8 * abs(f3_eigenvalue),
              f"[H4] lambda_max {res.eigenvalue} vs F3's {f3_eigenvalue}")
    return dict(rows=rep["laplacian"].n_rows, eigenvalue=res.eigenvalue,
                iterations=res.iterations, wall_s=wall, launches=counts)


def time_phase_h(device, card, run_h2) -> dict:
    """Kernel 1 per part (profiler device time against its bound, the
    compulsory bytes of that part's slots), the product and the halo
    exchange by CUDA events, the plain version and cuSPARSE on each part's
    block, and each counted solve of H2 again under the profiler: device
    and busy time, wall, idle share."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import spmv_plain
    from domain_decomposed_pde_solver_tpu_torch.parallel.sharded import (
        part_block_csr,
    )

    out = {}
    for P_, rec in run_h2["parts"].items():
        op, x = rec["op"], rec["x"]
        xe = op.extended(x)
        per_part = _per_part_ms(
            op, x, [lambda b=b, xp=xe[p]: b.matvec(xp)
                    for p, b in enumerate(op.parts)])
        parts = []
        for p, blk in enumerate(op.parts):
            nnz = int((blk.vals != 0).sum())
            b_ms, by = bound(sell_bytes(blk), 2.0 * nnz)
            S = part_block_csr(op.plan, p)  # the block, rows in blk's order
            csr = _csr_tensor(S.indptr, S.indices, S.data, S.n_cols,
                              torch.float32, device)
            xp, xs = xe[p], xe[p][: S.n_cols]
            parts.append(dict(
                ms=per_part[p], bound_ms=b_ms, bound_by=by,
                slots=blk.n_slots, nnz=nnz, bytes=sell_bytes(blk),
                plain_ms=time_ms(lambda blk=blk, xp=xp: spmv_plain(blk, xp)),
                library_ms=time_ms(lambda csr=csr, xs=xs: csr @ xs)))
        exch = profile_device(lambda op=op, x=x: op.extended(x))
        t = dict(
            per_part=parts,
            matvec_ms=time_ms(lambda op=op, x=x: op.matvec(x)),
            exchange_ms=time_ms(lambda op=op, x=x: op.extended(x)),
            exchange_device_ms=exch["device_ms"])
        log(f"[E] H2 P={P_}: kernel 1 per part (ms, bound ms): "
            f"{[(round(q['ms'], 5), round(q['bound_ms'], 5)) for q in parts]}"
            f"; the partitioned product {t['matvec_ms']:.4f} ms, the halo "
            f"exchange {t['exchange_ms']:.4f} ms ({exch['device_ms']:.4f} ms "
            f"of device time) [{card}]")
        out[f"P={P_}"] = t
    for label, (fn, counts) in run_h2["replays"].items():
        per_call = counts["sell_spmv"]["launches"]
        p = profile_device(fn, reps=1, kernel="sell_spmv_kernel",
                           per_call=per_call)
        top = sorted(p["kernels"].items(), key=lambda kv: -kv[1][1])[:6]
        out[label] = dict(replay_record(p), launches=per_call,
                          top_kernels={k[:80]: v for k, v in top})
        log(f"[E] {label}: {replay_text(out[label])}, {per_call} kernel-1 "
            f"launches; the largest kernels (launches, ms) "
            f"{json.dumps(out[label]['top_kernels'])} [{card}]")
    return out


def phase_h(device, kernels, refs, cells: int = MESH_CELLS,
            small_cells: int = SMALL_CELLS, exo=None, parts=H_PARTS,
            out=OUT) -> dict:
    """H1-H4 in order, each counted run with every launch counter at 0
    just before it; ``refs`` holds the numbers of the main process's
    paths it is checked against (``c_iterations``, ``d1_iterations``,
    ``d1_floor``, ``f3_eigenvalue``; a missing one is not checked)."""
    t0 = time.perf_counter()
    h1 = phase_h1(device, kernels, refs, cells, out)
    h2 = phase_h2(device, kernels, refs, h1, parts)
    h3 = phase_h3(device, kernels, small_cells)
    if exo is None:
        exo = OUT / f"box{BOX}.exo"  # path A's file, written when absent
        if not exo.exists():
            from domain_decomposed_pde_solver_tpu_torch.io import (
                box_mesh,
                write_exodus,
            )

            write_exodus(str(exo), box_mesh(BOX, BOX, BOX, "TETRA4"))
    h4 = phase_h4(device, kernels, exo, refs.get("f3_eigenvalue"))
    wall = time.perf_counter() - t0
    log(f"[H] wall {wall:.1f} s")
    return dict(H1=h1, H2=h2, H3=h3, H4=h4, wall_s=wall)


def phase_h_launches(run_h: dict, name: str) -> dict:
    """One kernel's launches in each counted run of phase H."""
    runs = {"H1": run_h["H1"]["launches"]}
    for P_, rec in run_h["H2"].items():
        runs[f"H2 jacobi P={P_}"] = rec["jacobi"]["launches"]
        if "halo_amg" in rec:
            runs[f"H2 halo-amg P={P_}"] = rec["halo_amg"]["launches"]
            for label, r in rec["schwarz"].items():
                runs[f"H2 schwarz {label} P={P_}"] = r["launches"]
    runs["H3"], runs["H4"] = run_h["H3"]["launches"], run_h["H4"]["launches"]
    return {k: c[name]["launches"] for k, c in runs.items()}


def phase_h_record(run_h) -> dict:
    """What the smoke's record keeps of phase H (numbers only)."""
    h1 = {k: v for k, v in run_h["H1"].items()
          if k not in ("system", "plan", "op", "hamg")}
    h1["dof"] = run_h["H1"]["system"].n_free
    h2 = {str(P_): {k: v for k, v in rec.items() if k not in ("op", "x")}
          for P_, rec in run_h["H2"]["parts"].items()}
    return dict(H1=h1, H2=h2, H3=run_h["H3"], H4=run_h["H4"],
                wall_s=run_h["wall_s"])


def phase_h_process(result: str, refs: str = "{}") -> int:
    """Phase H in a process of its own (``python3 chip_smoke.py --phase-h
    RESULT [REFS]``, started by :func:`run_phase_h`, or alone), as F and
    G: load the kernels (building them if needed), run :func:`phase_h`
    against the numbers in the JSON ``REFS`` (none alone: those checks are
    skipped), time it and write the record to ``RESULT``."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = _kernels.build_kernels()
    device = torch.device("cuda", 0)
    run = phase_h(device, kernels, json.loads(refs))
    rec = phase_h_record(run)
    rec["errs"] = run["H2"]["errs"]
    rec["timing"] = time_phase_h(device, card_line(), run["H2"])
    rec["card"] = card_line()
    pathlib.Path(result).write_text(json.dumps(rec))
    return 0


def run_phase_h(refs: dict, timeout: float = 900.0) -> dict:
    """Run :func:`phase_h_process` in a child process on the same card and
    return its record; fails if the child does."""
    result = OUT / "phase_h.json"
    result.unlink(missing_ok=True)
    OUT.mkdir(parents=True, exist_ok=True)
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, str(pathlib.Path(__file__)),
                           "--phase-h", str(result), json.dumps(refs)],
                          cwd=REPO, timeout=timeout)
    check(proc.returncode == 0 and result.exists(),
          f"[H] the phase H process exited with {proc.returncode}")
    return json.loads(result.read_text())


# ---------------------------------------------------------------------------
# I. The structured slab engines: the CLI's structured --partitions route,
#    the slab API, kernel 3 on every slab's window, the 10M box over slabs
# ---------------------------------------------------------------------------

I_PARTS = 4
I3_L = 66  # the 10M box's slabs at bz = 4, brick 6, P = 4


def _window_bound(op, p, vb: int) -> tuple:
    """Kernel 3's bound on part ``p``'s window: x on the part's real nodes
    and on its halo layers that hold real nodes (each read once), corr on
    its real nodes, y on its owned ``L*myp*mxp`` slots (pads written 0);
    flops per real node as :func:`_pad_bound` counts them."""
    mx, my, _ = op.dims
    real = op.zlim[p] * mx * my
    halo = (p > 0) + (p + 1 < op.nparts and op.zlim[p + 1] > 0)
    nbytes = ((real + halo * mx * my) * vb
              + real * op.corr_ext.element_size() + op.n_pad * vb)
    flops = real * (len(op.taps) + 2 * len(op.groups) + 2)
    return (*bound(nbytes, flops), nbytes)


def plan_live(op, x):
    """``x`` with every pad slot and dead layer set to 0 (the slab
    vectors' invariant)."""
    import torch

    mx, my, _ = op.dims
    live = torch.zeros(op.nparts, op.L, op.myp, op.mxp, dtype=torch.bool,
                       device=x.device)
    for p in range(op.nparts):
        live[p, : op.zlim[p], 1: my + 1, :mx] = True
    return x * live.reshape(op.nparts, -1)


def _window_checks(device, op, errs, tag, seed: int = 29) -> dict:
    """Every part's kernel-3 window launch against its plain version on
    the same window, in f32 (relative 1e-6) and f64 (1e-12); the guard
    layers, the last slab's dead layers and every pad slot exactly 0.
    Adds the largest absolute differences to ``errs`` (``pad_stencil``)
    and returns them by part and type; these launches are not counted
    runs."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        pad_window_reference,
        pad_window_spmv,
    )

    rng = np.random.default_rng(seed)
    mx, my, _ = op.dims
    live_rows = torch.zeros(op.myp, op.mxp, dtype=torch.bool, device=device)
    live_rows[1: my + 1, :mx] = True
    out = {}
    for name, tol in (("float32", 1e-6), ("float64", 1e-12)):
        x = plan_live(op, torch.as_tensor(
            rng.normal(size=(op.nparts, op.n_pad)), dtype=getattr(torch, name),
            device=device))
        xe = op.extended(x)
        for p in range(op.nparts):
            y = pad_window_spmv(op, xe[p], op.corr_ext[p], op.zlim[p])
            ref = pad_window_reference(op, xe[p], op.corr_ext[p], op.zlim[p])
            live = torch.zeros(op.L + 2, op.myp, op.mxp, dtype=torch.bool,
                               device=device)
            live[1: op.zlim[p] + 1] = live_rows
            mine = {}
            _compare(f"kernel 3, part {p} of {op.nparts} ({op.zlim[p]} of "
                     f"{op.L} layers real)", y, ref, tol, mine,
                     "pad_stencil", mask=~live.reshape(-1), tag=tag)
            out[f"part {p} {name}"] = mine["pad_stencil"]
            errs["pad_stencil"] = max(errs.get("pad_stencil", 0.0),
                                      mine["pad_stencil"])
    return out


def phase_i1(device, kernels, refs, exo, out=OUT, parts=I_PARTS) -> dict:
    """The CLI's structured route on path A's file: ``--partitions P
    --precond amg --dtype float64 --tolerance 1e-8 --no-snapshots``, the
    refinement over pad-stencil slabs (kernel 3 in f32 and f64 on every
    window)."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.cli.solve import main
    from domain_decomposed_pde_solver_tpu_torch.io import read_nodal_vars

    sol = out / "i1_solution.exo"
    args = ["--input", exo, "--solution", sol, "--partitions", parts,
            "--precond", "amg", "--dtype", "float64", "--tolerance", 1e-8,
            "--no-snapshots", "--verbose"]
    args += [] if device.type == "cuda" else ["--cpu"]
    rep = {}
    (rc, _text), counts, wall = _run_counted(
        kernels, lambda: _captured(lambda: main([str(a) for a in args],
                                                report=rep)))
    sy, mr, samg = rep["system"], rep["mixed"], rep["precond"]
    _names, _times, vals = read_nodal_vars(str(sol))
    u = vals[-1, 0, sy.free_to_node]
    rr = host_relres(sy.A, u, sy.b)
    phases = rep["timer"].as_dict()
    plan = samg.plan
    log(f"[I1] CLI --partitions {parts} --precond amg --dtype float64 on "
        f"{sy.n_free} DOF: rc {rc}, {type(samg).__name__} over slabs of "
        f"L = {plan.L} (bz {plan.bz}, windows' last layers "
        f"{plan.zlims[:, 0, 1].tolist()}), {mr.refinements} sweeps, "
        f"{mr.inner_iterations} inner iterations (path A: "
        f"{refs.get('a_sweeps')} and {refs.get('a_inner')}), relres "
        f"{mr.relres:.3e}, host f64 relres {rr:.3e}, values "
        f"[{u.min():.6g}, {u.max():.6g}]; wall {wall:.1f} s; phases "
        f"{json.dumps(phases)}; refinement timings {json.dumps(mr.timings)}"
        f"; launches {_launched(counts)}")
    check(rc == 0 and mr.converged, f"[I1] the CLI exited with {rc}")
    check(type(samg).__name__ == "SlabPadAMG",
          f"[I1] the route took {type(samg).__name__}, not the slab-pad AMG")
    check(rr <= 1.5e-8, f"[I1] host relres {rr:.3e} > 1.5e-8")
    check(bool(np.isfinite(u).all()) and 100.0 <= float(u.min())
          and float(u.max()) <= 1000.0,
          f"[I1] values [{u.min()}, {u.max()}] outside [100, 1000]")
    if "a_sweeps" in refs:
        check(mr.refinements == refs["a_sweeps"],
              f"[I1] {mr.refinements} sweeps, path A {refs['a_sweeps']}")
        check(abs(mr.inner_iterations - refs["a_inner"]) <= mr.refinements,
              f"[I1] {mr.inner_iterations} inner iterations, path A "
              f"{refs['a_inner']}")
    if device.type == "cuda":
        k3 = counts["pad_stencil"]
        check(any(e.startswith("ddps_pad_stencil_f32") for e in k3["by_entry"])
              and any(e.startswith("ddps_pad_stencil_f64")
                      for e in k3["by_entry"]),
              f"[I1] kernel 3 did not run in f32 and f64: {k3['by_entry']}")
    return dict(system=sy, samg=samg, sweeps=mr.refinements,
                inner_iterations=mr.inner_iterations, relres=mr.relres,
                host_relres=rr, timings_ms=mr.timings, phases_s=phases,
                cli_wall_s=wall, launches=counts, L=plan.L, bz=plan.bz,
                zlims=plan.zlims[:, 0, 1].tolist(),
                tail_levels=[type(lvl.A).__name__
                             for lvl in samg.tail.levels])


def phase_i2(device, kernels, run_i1) -> dict:
    """The slab API on I1's system and slab hierarchy: the slab-pad AMG in
    f32 against the single-device CG+AMG on the same pad operator and
    hierarchy, Jacobi-CG over the slabs against the single-device
    Jacobi-CG on the pad operator, the global AMG over slab DIA (f64)
    against the slab-pad count, CG with the brick-Schwarz preconditioner
    against slab Jacobi-CG; then every part's window launch against its
    plain version."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        build_slab_amg,
        build_slab_brick_precond,
        build_slab_plan,
        make_device_mesh,
        slab_amg_cg_solve,
        slab_cg_solve,
        slab_pad_amg_cg_solve,
        slab_pad_cg_solve,
    )
    from domain_decomposed_pde_solver_tpu_torch.solvers import (
        cg_solve,
        jacobi_preconditioner,
        smoothed_aggregation_setup,
    )

    sy, samg = run_i1["system"], run_i1["samg"]
    plan, A = samg.plan, samg.pad_op
    dims, P_ = plan.dims, plan.nparts
    b32 = sy.b.astype(np.float32)
    z32 = np.zeros_like(b32)
    res, times = {}, {}

    def counted(label, fn):
        t0 = time.perf_counter()
        (x, r), counts, wall = _run_counted(kernels, fn)
        rr = host_relres(sy.A, x, sy.b)
        res[label] = dict(iterations=r.iterations, relres=r.relres,
                          host_relres=rr, converged=r.converged,
                          wall_s=wall, launches=counts)
        times[label] = time.perf_counter() - t0
        log(f"[I2] {label}: {r.iterations} iterations, relres "
            f"{r.relres:.3e}, host f64 relres {rr:.3e}, {wall:.3f} s; "
            f"launches {_launched(counts)}")
        check(r.converged, f"[I2] {label} did not converge")
        return x, r

    def pad_amg():
        return slab_pad_amg_cg_solve(samg, b32, z32, tol=1e-6)

    counted("slab-pad AMG f32", pad_amg)
    t0 = time.perf_counter()
    M1 = smoothed_aggregation_setup(sy.A, dtype=torch.float32, grid_dims=dims,
                                    fine_operator=A)
    times["single-device AMG set-up"] = time.perf_counter() - t0
    b = A.put_vector(b32)
    r1 = cg_solve(A, b, torch.zeros_like(b), precond=M1, tol=1e-6,
                  maxiter=300)
    its = res["slab-pad AMG f32"]["iterations"]
    log(f"[I2] single-device CG+AMG on the same pad operator: "
        f"{r1.iterations} iterations")
    check(abs(its - r1.iterations) <= 1, f"[I2] slab-pad AMG {its} "
          f"iterations, single device {r1.iterations}")
    check(res["slab-pad AMG f32"]["host_relres"] <= 2e-6,
          "[I2] slab-pad AMG host relres > 2e-6")

    def pad_jacobi():
        return slab_pad_cg_solve(plan, b32, z32, tol=1e-6, maxiter=5000)

    counted("slab-pad Jacobi f32", pad_jacobi)
    rj = cg_solve(A, b, torch.zeros_like(b), precond=jacobi_preconditioner(A),
                  tol=1e-6, maxiter=5000)
    its = res["slab-pad Jacobi f32"]["iterations"]
    log(f"[I2] single-device Jacobi-CG on the pad operator: "
        f"{rj.iterations} iterations")
    check(abs(its - rj.iterations) <= max(2, 0.02 * rj.iterations),
          f"[I2] slab-pad Jacobi-CG {its} iterations, single device "
          f"{rj.iterations}")

    t0 = time.perf_counter()
    damg = build_slab_amg(sy.A, dims, P_, dtype=np.float64, device=device)
    times["slab DIA AMG set-up"] = time.perf_counter() - t0
    check(damg is not None and type(damg.A).__name__ == "SlabDIAOperator",
          "[I2] no slab DIA hierarchy")
    counted("slab DIA AMG f64", lambda: slab_amg_cg_solve(
        damg, sy.b, np.zeros(sy.n_free), tol=1e-6))
    check(abs(res["slab DIA AMG f64"]["iterations"]
              - res["slab-pad AMG f32"]["iterations"]) <= 1,
          "[I2] slab DIA AMG not within 1 of the slab-pad AMG")

    t0 = time.perf_counter()
    dplan = build_slab_plan(sy.A, P_, dtype=np.float32,
                            row_align=dims[0] * dims[1])
    bp = build_slab_brick_precond(dplan, dims)
    times["brick-Schwarz set-up"] = time.perf_counter() - t0
    mesh = make_device_mesh(P_, [device])
    counted("slab DIA Jacobi f32", lambda: slab_cg_solve(
        dplan, b32, z32, tol=1e-6, maxiter=5000, mesh=mesh))
    counted("slab DIA brick-Schwarz f32", lambda: slab_cg_solve(
        dplan, b32, z32, tol=1e-6, maxiter=5000, mesh=mesh,
        brick_precond=bp))
    check(res["slab DIA brick-Schwarz f32"]["iterations"]
          <= res["slab DIA Jacobi f32"]["iterations"],
          "[I2] brick-Schwarz took more iterations than Jacobi")

    errs = {}
    op = plan.make_ops()
    window_errs = _window_checks(device, op, errs, "I2")
    return dict(solves=res, times_s=times,
                single_device=dict(amg=r1.iterations, jacobi=rj.iterations),
                window_errs=window_errs, errs=errs, op=op,
                replays={"I2 slab-pad AMG f32": (
                    pad_amg, res["slab-pad AMG f32"]["launches"])})


def phase_i3(device, kernels, refs, n: int = G_BOX,
             parts: int = I_PARTS) -> dict:
    """The 10M box over slabs: ``structured_box_system(n, n, n)``, the pad
    operator at bz = 4 from ``structured_box_parts`` built on the card,
    ``build_slab_pad_amg(..., pad_op=...)``; CG+AMG to 1e-6 in f32 against
    phase G's count, the refinement to 1e-8 in G_SWEEPS sweeps with a host
    f64 relres <= 1.5e-8; every part's window launch against its plain
    version."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.models.structured import (
        structured_box_parts,
        structured_box_system,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        pad_stencil_from_parts,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        build_slab_pad_amg,
        slab_pad_amg_cg_solve,
        slab_pad_amg_refine_solve,
    )

    times = {}
    t0 = time.perf_counter()
    sy = structured_box_system(n, n, n, "TETRA4")
    times["assembly_s"] = time.perf_counter() - t0
    dims = (n - 1, n + 1, n + 1)
    t0 = time.perf_counter()
    po = structured_box_parts(n, n, n, "TETRA4", device=device)
    pad_op = pad_stencil_from_parts(po["parts"], bz=4, device=device)
    del po
    sync(device)
    times["operator_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    samg = build_slab_pad_amg(sy.A, dims, parts, pad_op=pad_op)
    sync(device)
    times["slab_amg_setup_s"] = time.perf_counter() - t0
    check(samg is not None, "[I3] no slab-pad hierarchy")
    plan = samg.plan
    log(f"[I3] box {n}^3: {sy.n_free} DOF, free grid {dims}, slabs of L = "
        f"{plan.L} (bz {plan.bz}), windows' last layers "
        f"{plan.zlims[:, 0, 1].tolist()}, window {plan.L + 2} x {plan.myp} "
        f"x {plan.mxp}; tail {[type(lvl.A).__name__ for lvl in samg.tail.levels]}"
        f"; host set-up {json.dumps({k: round(v, 3) for k, v in times.items()})}")
    if n == G_BOX and parts == I_PARTS:
        check(plan.L == I3_L, f"[I3] L = {plan.L}, not {I3_L}")
    bscale = float(np.abs(sy.b).max())
    bh = (sy.b / bscale).astype(np.float32)

    def cg():
        return slab_pad_amg_cg_solve(samg, bh, np.zeros_like(bh), tol=1e-6,
                                     maxiter=100)

    def refine():
        return slab_pad_amg_refine_solve(samg, b=sy.b, tol=1e-8,
                                         inner_tol=1e-6, inner_maxiter=100)

    (_x, r), c_cg, w_cg = _run_counted(kernels, cg)
    mr, c_ref, w_ref = _run_counted(kernels, refine)
    t0 = time.perf_counter()
    rr = host_relres(sy.A, mr.x, sy.b)
    times["host_check_s"] = time.perf_counter() - t0
    log(f"[I3] CG+AMG to 1e-6 (f32): {r.iterations} iterations (phase G: "
        f"{refs.get('g_cg')}), relres {r.relres:.3e}, {w_cg:.3f} s; "
        f"launches {_launched(c_cg)}")
    log(f"[I3] refinement to 1e-8: {mr.refinements} sweeps, "
        f"{mr.inner_iterations} inner iterations, relres {mr.relres:.3e}, "
        f"host f64 relres {rr:.3e}, timings {json.dumps(mr.timings)}, "
        f"{w_ref:.3f} s; launches {_launched(c_ref)}")
    check(r.converged and mr.converged, "[I3] a solve did not converge")
    if "g_cg" in refs:
        check(abs(r.iterations - refs["g_cg"]) <= 1,
              f"[I3] {r.iterations} iterations, phase G {refs['g_cg']}")
    check(G_SWEEPS[0] <= mr.refinements <= G_SWEEPS[1],
          f"[I3] {mr.refinements} sweeps, not within {G_SWEEPS}")
    check(rr <= 1.5e-8, f"[I3] host relres {rr:.3e} > 1.5e-8")
    check(100.0 <= float(mr.x.min()) and float(mr.x.max()) <= 1000.0,
          "[I3] values outside [100, 1000]")
    if device.type == "cuda":
        for label, c in (("CG", c_cg), ("refinement", c_ref)):
            k3 = c["pad_stencil"]
            check(k3["launches"] > 0 and k3.get("by_form", {}).get(
                "window") == k3["launches"],
                  f"[I3] {label}: kernel 3 not launched on windows only")
    errs = {}
    op = plan.make_ops()
    window_errs = _window_checks(device, op, errs, "I3")
    return dict(dof=sy.n_free, dims=list(dims), L=plan.L, bz=plan.bz,
                zlims=plan.zlims[:, 0, 1].tolist(), times=times,
                cg=dict(iterations=r.iterations, relres=r.relres,
                        wall_s=w_cg),
                refine=dict(sweeps=mr.refinements,
                            inner_iterations=mr.inner_iterations,
                            relres=mr.relres, timings=mr.timings,
                            wall_s=w_ref),
                host_relres=rr, launches=dict(cg=c_cg, refine=c_ref),
                window_errs=window_errs, errs=errs, op=op,
                replays={"I3 cg": (cg, c_cg), "I3 refine": (refine, c_ref)})


def phase_i(device, kernels, refs, exo=None, n10: int = G_BOX,
            parts: int = I_PARTS, out=OUT) -> dict:
    """I1-I3 in order, each counted run with every launch counter at 0
    just before it; ``refs`` holds the main process's numbers they are
    checked against (``a_sweeps``, ``a_inner``: path A's refinement;
    ``g_cg``: phase G's CG count; a missing one is not checked)."""
    t0 = time.perf_counter()
    out.mkdir(parents=True, exist_ok=True)
    if exo is None:
        exo = OUT / f"box{BOX}.exo"  # path A's file, written when absent
        if not exo.exists():
            from domain_decomposed_pde_solver_tpu_torch.io import (
                box_mesh,
                write_exodus,
            )

            write_exodus(str(exo), box_mesh(BOX, BOX, BOX, "TETRA4"))
    i1 = phase_i1(device, kernels, refs, exo, out, parts)
    i2 = phase_i2(device, kernels, i1)
    i3 = phase_i3(device, kernels, refs, n10, parts)
    errs = {}
    for run in (i2, i3):
        for key, e in run["errs"].items():
            errs[key] = max(errs.get(key, 0.0), e)
    wall = time.perf_counter() - t0
    log(f"[I] wall {wall:.1f} s")
    return dict(I1=i1, I2=i2, I3=i3, errs=errs, wall_s=wall)


def time_phase_i(device, card, run_i) -> dict:
    """Kernel 3 per part on the slab windows of I2 (1M) and I3 (10M):
    profiler device time of each part's launch in a slab product, beside
    its bound and its plain version; the exchange by CUDA events and
    device time; the slab product whole; and each counted solve again
    under the profiler (device and busy time, wall, idle share)."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        pad_window_reference,
        pad_window_spmv,
    )

    out = {}
    for tag in ("I2", "I3"):
        op = run_i[tag]["op"]
        for name in ("float32", "float64"):
            x = torch.randn(op.nparts, op.n_pad, device=device,
                            dtype=getattr(torch, name))
            x = plan_live(op, x)
            xe = op.extended(x)
            per_part = _per_part_ms(
                op, x, [lambda p=p: pad_window_spmv(op, xe[p], op.corr_ext[p],
                                                    op.zlim[p])
                        for p in range(op.nparts)],
                kernel="pad_stencil_kernel")
            parts = []
            for p in range(op.nparts):
                b_ms, by, nbytes = _window_bound(op, p, x.element_size())
                parts.append(dict(
                    ms=per_part[p], bound_ms=b_ms, bound_by=by, bytes=nbytes,
                    real_layers=op.zlim[p],
                    plain_ms=time_ms(lambda p=p: pad_window_reference(
                        op, xe[p], op.corr_ext[p], op.zlim[p]), reps=10)))
            exch = profile_device(lambda: op.extended(x))
            t = dict(per_part=parts, matvec_ms=time_ms(lambda: op.matvec(x)),
                     exchange_ms=time_ms(lambda: op.extended(x)),
                     exchange_device_ms=exch["device_ms"])
            log(f"[E] {tag} {name}: kernel 3 per part (ms, bound ms): "
                f"{[(round(q['ms'], 5), round(q['bound_ms'], 5)) for q in parts]}"
                f"; plain per part {[round(q['plain_ms'], 4) for q in parts]}"
                f" ms; the slab product {t['matvec_ms']:.4f} ms, the exchange "
                f"{t['exchange_ms']:.4f} ms ({exch['device_ms']:.4f} ms of "
                f"device time) [{card}]")
            out[f"{tag} {name}"] = t
    replays = {**run_i["I2"]["replays"], **run_i["I3"]["replays"]}
    for label, (fn, counts) in replays.items():
        per_call = counts["pad_stencil"]["launches"]
        p = profile_device(fn, reps=1, kernel="pad_stencil_kernel",
                           per_call=per_call)
        top = sorted(p["kernels"].items(), key=lambda kv: -kv[1][1])[:6]
        out[label] = dict(replay_record(p), launches=per_call,
                          top_kernels={k[:80]: v for k, v in top})
        log(f"[E] {label}: {replay_text(out[label])}, {per_call} kernel-3 "
            f"launches; the largest kernels (launches, ms) "
            f"{json.dumps(out[label]['top_kernels'])} [{card}]")
    return out


def phase_i_launches(run_i: dict, name: str) -> dict:
    """One kernel's launches in each counted run of phase I."""
    runs = {"I1": run_i["I1"]["launches"]}
    for label, r in run_i["I2"]["solves"].items():
        runs[f"I2 {label}"] = r["launches"]
    runs["I3 cg"] = run_i["I3"]["launches"]["cg"]
    runs["I3 refine"] = run_i["I3"]["launches"]["refine"]
    return {k: c[name]["launches"] for k, c in runs.items()}


def phase_i_record(run_i) -> dict:
    """What the smoke's record keeps of phase I (numbers only)."""
    i1 = {k: v for k, v in run_i["I1"].items()
          if k not in ("system", "samg")}
    i1["dof"] = run_i["I1"]["system"].n_free
    i2 = {k: v for k, v in run_i["I2"].items()
          if k not in ("op", "replays", "errs")}
    i3 = {k: v for k, v in run_i["I3"].items()
          if k not in ("op", "replays", "errs")}
    return dict(I1=i1, I2=i2, I3=i3, wall_s=run_i["wall_s"])


def phase_i_process(result: str, refs: str = "{}") -> int:
    """Phase I in a process of its own (``python3 chip_smoke.py --phase-i
    RESULT [REFS]``, started by :func:`run_phase_i`, or alone), as F, G and
    H: load the kernels (building them if needed), run :func:`phase_i`
    against the numbers in the JSON ``REFS`` (none alone: those checks are
    skipped), time it and write the record to ``RESULT``; every line it
    logs carries the card's name and power limit."""
    global LOG_TAG
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = _kernels.build_kernels()
    device = torch.device("cuda", 0)
    card = card_line()
    LOG_TAG = f" [{card}]"
    run = phase_i(device, kernels, json.loads(refs))
    rec = phase_i_record(run)
    rec["errs"] = run["errs"]
    rec["timing"] = time_phase_i(device, card, run)
    rec["card"] = card
    pathlib.Path(result).write_text(json.dumps(rec))
    return 0


def run_phase_i(refs: dict, timeout: float = 900.0) -> dict:
    """Run :func:`phase_i_process` in a child process on the same card and
    return its record; fails if the child does."""
    result = OUT / "phase_i.json"
    result.unlink(missing_ok=True)
    OUT.mkdir(parents=True, exist_ok=True)
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, str(pathlib.Path(__file__)),
                           "--phase-i", str(result), json.dumps(refs)],
                          cwd=REPO, timeout=timeout)
    check(proc.returncode == 0 and result.exists(),
          f"[I] the phase I process exited with {proc.returncode}")
    return json.loads(result.read_text())


# ---------------------------------------------------------------------------
# J. The multi-process decomposition: two processes over torch.distributed
#    on the one card (distributed assembly, kernel 1 across processes, the
#    slab CG across processes, sharded checkpoints)
# ---------------------------------------------------------------------------

J_PARTS = 4
J_WORLD = 2
J_TIMEOUT = 600.0  # seconds the workers may take, and a collective may wait
J_FULL = dict(hex_box=BOX, tet_box=BOX, hex_dof=BOX_DOF, tet_dof=BOX_DOF,
              device="cuda")


def _j_device(cfg: dict, rank: int = 0):
    import torch

    if cfg["device"] == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _event_ms(fn, device, reps: int) -> float:
    """:func:`time_ms` on the card; on the CPU the host clock around
    ``reps`` calls after three warm-up calls.  Both processes of a
    collective call it alike."""
    if device.type == "cuda":
        return time_ms(fn, reps)
    for _ in range(3):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _timed(fn, device):
    """``fn()`` and its milliseconds: CUDA events on the card (the wall of
    a solve whose host waits on the card), the host clock on the CPU."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(stop)


def _jacobi(op):
    import torch

    d = op.diagonal()
    return torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 0.0)


def _j1_worker(device, cfg, exo, rank) -> tuple:
    """J1 in one worker: the distributed assembly, rank 0's parity with the
    global plan, one product, f64 Jacobi-CG to 1e-8."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.io import read_exodus
    from domain_decomposed_pde_solver_tpu_torch.models import (
        assemble_heat_system,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        build_halo_plan,
        sharded_cg_solve,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel.distassembly import (
        assemble_heat_multihost,
    )

    t0 = time.perf_counter()
    op, b_s, plan, state = assemble_heat_multihost(
        str(exo), nparts=J_PARTS, dtype=np.float64, device=device)
    rec = dict(assembly_s=time.perf_counter() - t0, n_free=state.n_free,
               n_local=plan.n_local, H=plan.halo_width, K=plan.ell_width,
               local_parts=op.mesh.local_parts, operator=type(op).__name__)
    check(state.n_free == cfg["hex_dof"],
          f"[J1] {state.n_free} free rows, not {cfg['hex_dof']}")
    k = op.mesh.local_parts
    check(plan.ell_cols.shape[0] == k, "[J1] the plan holds other blocks")
    S = b_ref = None
    if rank == 0:
        # JAX's parity check (tests/distassembly_worker.py:52-66): this
        # rank's blocks are bit-identical slices of the global plan.
        t0 = time.perf_counter()
        sy = assemble_heat_system(read_exodus(str(exo)))
        plan_g = build_halo_plan(sy.A, state.owner_free, J_PARTS)
        rec["global_s"] = time.perf_counter() - t0
        check(plan.n_local == plan_g.n_local
              and plan.halo_width == plan_g.halo_width,
              "[J1] the widths differ from the global plan's")
        for name in ("ell_cols", "ell_vals", "send_idx", "row_valid"):
            check(np.array_equal(getattr(plan, name),
                                 getattr(plan_g, name)[:k]),
                  f"[J1] {name} is not the global plan's slice")
        rec["bit_identical"] = True
        S, b_ref = sy.A, sy.b
    x = np.random.default_rng(7).standard_normal(state.n_free)
    y = op.get_vector(op.matvec(op.put_vector(x)))
    b = op.get_vector(b_s)
    if rank == 0:
        y_ref = S.matvec(x)
        err = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
        check(err <= 1e-9, f"[J1] sharded product off by {err:.3e}")
        check(np.array_equal(b, b_ref), "[J1] b differs from the global b")
        rec["product_relerr"] = err
    res, ms = _timed(lambda: sharded_cg_solve(
        op, b_s, torch.zeros_like(b_s), precond_diag=_jacobi(op), tol=1e-8,
        maxiter=20000), device)
    u = op.get_vector(res.x)
    check(res.converged, f"[J1] CG stopped at relres {res.relres:.3e}")
    rec.update(iterations=res.iterations, relres=res.relres, solve_ms=ms)
    if rank == 0:
        rec["host_relres"] = host_relres(S, u, b_ref)
        check(rec["host_relres"] <= 1.5e-8,
              f"[J1] host relres {rec['host_relres']:.3e} > 1.5e-8")
    log(f"[J1] rank {rank}: {state.n_free} rows, {k} parts, assembly "
        f"{rec['assembly_s']:.2f} s; f64 Jacobi-CG {res.iterations} "
        f"iterations in {ms:.1f} ms")
    return rec, op, plan, b, S


def _j2_worker(device, kernels, op, plan, b, S, rank, errs) -> dict:
    """J2 in one worker: BSGShardedOperator over the process mesh, kernel 1
    on each local part, f32 Jacobi-CG to 1e-6."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import (
        bsg_spmv,
        spmv_plain,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        BSGShardedOperator,
        sharded_cg_solve,
    )

    t0 = time.perf_counter()
    bop = BSGShardedOperator.from_plan(plan, op.mesh, dtype=np.float32)
    k = len(bop.parts)
    rec = dict(pack_s=time.perf_counter() - t0, storage=bop.parts[0].storage,
               parts=k, rows=[blk.n_pad for blk in bop.parts],
               slots=[blk.n_slots for blk in bop.parts])
    b32 = bop.put_vector(b)
    x0 = torch.zeros_like(b32)
    inv = _jacobi(bop)
    reset_counts(kernels)
    bop.matvec(b32)
    sync(device)
    rec["per_product"] = read_counts(kernels)["sell_spmv"]["launches"]
    reset_counts(kernels)
    res, ms = _timed(lambda: sharded_cg_solve(
        bop, b32, x0, precond_diag=inv, tol=1e-6, maxiter=20000), device)
    counts = read_counts(kernels)
    rec.update(iterations=res.iterations, relres=res.relres, solve_ms=ms,
               launches=counts["sell_spmv"]["launches"], counts=counts)
    check(res.converged, f"[J2] CG stopped at relres {res.relres:.3e}")
    if device.type == "cuda":
        check(rec["per_product"] == k, f"[J2] {rec['per_product']} kernel-1 "
              f"launches in a product over {k} parts")
        check(rec["launches"] == k * (res.iterations + 1),
              f"[J2] {rec['launches']} kernel-1 launches in "
              f"{res.iterations + 1} products over {k} parts")
    u = bop.get_vector(res.x)
    # Each local part's launch against its plain version (not counted).
    rng = np.random.default_rng(17 + rank)
    xe = bop.extended(torch.as_tensor(
        rng.normal(size=(k, plan.n_local)), dtype=torch.float32,
        device=device))
    rows = np.arange(bop.parts[0].n_pad)
    mine = {}
    for p, blk in enumerate(bop.parts):
        _compare(f"rank {rank} part {bop.mesh.parts_lo + p} ({blk.n_pad} "
                 f"rows, {blk.storage})", bsg_spmv(blk, xe[p]),
                 spmv_plain(blk, xe[p]), 1e-6, mine, "sell_spmv",
                 mask=torch.as_tensor(rows >= plan.n_local, device=device),
                 tag="J2")
    rec["max_abs_err"] = mine["sell_spmv"]
    errs["sell_spmv"] = max(errs.get("sell_spmv", 0.0), mine["sell_spmv"])
    if rank == 0:
        rec["host_relres"] = host_relres(S, u, b)
        rec["f32_floor"] = f32_floor(S, u, b)
        check(rec["host_relres"] <= 5e-6 + rec["f32_floor"],
              f"[J2] host relres {rec['host_relres']:.3e} > 5e-6 + "
              f"{rec['f32_floor']:.3e}")
    log(f"[J2] rank {rank}: {k} parts ({rec['storage']}), "
        f"{rec['per_product']} kernel-1 launches per product; f32 "
        f"Jacobi-CG {res.iterations} iterations in {ms:.1f} ms, "
        f"{rec['launches']} launches")
    return rec


def _tet_system(cfg):
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
    from domain_decomposed_pde_solver_tpu_torch.models import (
        assemble_heat_system,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel.slab import (
        build_slab_plan,
    )

    n = cfg["tet_box"]
    sy = assemble_heat_system(box_mesh(n, n, n, "TETRA4"))
    check(sy.A.n_rows == cfg["tet_dof"], f"[J3] {sy.A.n_rows} DOF")
    plan = build_slab_plan(sy.A, nparts=J_PARTS)
    check(plan is not None, "[J3] no slab plan")
    b = (sy.b / np.abs(sy.b).max()).astype(np.float32)
    return sy, plan, b


def _j3_worker(device, cfg, out, rank) -> tuple:
    """J3 in one worker: ``multihost_slab_cg_solve`` on path A's system,
    the full answer and a sharded checkpoint of the iterate."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        make_device_mesh,
        multihost_slab_cg_solve,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel.collectives import (
        gather_parts,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel.multihost import (
        save_sharded_checkpoint,
    )

    t0 = time.perf_counter()
    sy, plan, b = _tet_system(cfg)
    rec = dict(build_s=time.perf_counter() - t0, slab=plan.slab,
               halo=plan.halo)
    mesh = make_device_mesh(J_PARTS, [device])
    (x, res), ms = _timed(lambda: multihost_slab_cg_solve(
        plan, b, np.zeros_like(b), tol=1e-6, maxiter=20000, mesh=mesh), device)
    check(res.converged, f"[J3] CG stopped at relres {res.relres:.3e}")
    rec.update(iterations=res.iterations, relres=res.relres, solve_ms=ms)
    np.save(out / f"j3_x.rank{rank}.npy", x)
    save_sharded_checkpoint(str(out / "j3_ck"), {"x": res.x})
    it = gather_parts(res.x).cpu().numpy()
    if rank == 0:
        np.save(out / "j3_iterate.npy", it)
    rec["host_relres"] = host_relres(sy.A, x, b)
    rec["f32_floor"] = f32_floor(sy.A, x, b)
    check(rec["host_relres"] <= 5e-6 + rec["f32_floor"],
          f"[J3] host relres {rec['host_relres']:.3e} > 5e-6 + "
          f"{rec['f32_floor']:.3e}")
    log(f"[J3] rank {rank}: slab CG {res.iterations} iterations in "
        f"{ms:.1f} ms, host relres {rec['host_relres']:.3e}")
    return rec, plan


def _collective_ms(device, op, slab_plan, reps: int = 50) -> dict:
    """One ``psum_dot``, one ``halo_exchange`` and one ``neighbour_strips``
    on the vectors of J1 and J3 (over processes: the local parts, every
    timing started after a barrier, so no process waits there for one
    still busy with earlier work)."""
    import torch
    import torch.distributed as dist

    from domain_decomposed_pde_solver_tpu_torch.parallel.sharded import (
        halo_exchange,
        psum_dot,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel.slab import (
        neighbour_strips,
    )

    g = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(op.cols.shape[:2], generator=g, device=device,
                    dtype=torch.float64)
    xs = torch.randn((x.shape[0], slab_plan.slab), generator=g,
                     device=device, dtype=torch.float32)
    calls = dict(
        psum_dot=lambda: psum_dot(x, x, op.mesh),
        halo_exchange=lambda: halo_exchange(x, op.halo_idx, op.mesh),
        neighbour_strips=lambda: neighbour_strips(xs, slab_plan.halo,
                                                  op.mesh))
    out = {}
    for name, fn in calls.items():
        if dist.is_initialized():
            dist.barrier()
        out[name] = _event_ms(fn, device, reps)
    return out


def phase_j_worker(rank: str, world: str, addr: str, out: str,
                   cfg: str = "{}") -> int:
    """One worker of phase J (``python3 chip_smoke.py --phase-j-worker RANK
    WORLD URL OUT [CFG]``): join the process group at ``URL``, run J1-J3
    and the collectives' timing over its parts, and write its record to
    ``OUT/phase_j.rank{RANK}.json``.  ``CFG``: JSON overrides of
    :data:`J_FULL` (the CPU tests' sizes)."""
    import logging
    import resource

    import torch
    import torch.distributed as dist

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        initialize_multihost,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel.collectives import (
        staged,
    )

    rank, world = int(rank), int(world)
    cfg = {**J_FULL, **json.loads(cfg)}
    out = pathlib.Path(out)
    device = _j_device(cfg, rank)
    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stdout)
    torch.set_num_threads(2)  # the parent and the other worker share the host
    kernels = _kernels.KERNELS
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        kernels = _kernels.build_kernels()  # built by the parent: a load
    t_start = time.perf_counter()
    got = initialize_multihost(addr, world, rank, device=cfg["device"],
                               timeout_s=J_TIMEOUT)
    check(got == rank, f"[J] rank {got}, not {rank}")
    rec = dict(rank=rank, world=world, backend=dist.get_backend(),
               staged=staged(device), device=str(device))
    errs = {}
    j1, op, plan, b, S = _j1_worker(device, cfg, out / cfg["hex_exo"], rank)
    rec["J1"] = j1
    rec["J2"] = _j2_worker(device, kernels, op, plan, b, S, rank, errs)
    del S
    rec["J3"], slab_plan = _j3_worker(device, cfg, out, rank)
    rec["collectives_ms"] = _collective_ms(device, op, slab_plan)
    rec["errs"] = errs
    rec["wall_s"] = time.perf_counter() - t_start
    rec["peak_rss_mb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1024
    log(f"[J] rank {rank}: collectives (ms) "
        f"{json.dumps(rec['collectives_ms'])}, peak RSS "
        f"{rec['peak_rss_mb']:.0f} MiB, {rec['wall_s']:.1f} s")
    dist.destroy_process_group()
    (out / f"phase_j.rank{rank}.json").write_text(json.dumps(rec))
    return 0


def _wait_workers(procs, deadline: float) -> None:
    """Wait for every worker until ``deadline`` (host clock); a worker that
    fails or outlives it ends the phase, and the others are killed."""
    try:
        while any(p.poll() is None for p in procs):
            for i, p in enumerate(procs):
                check(p.poll() in (None, 0),
                      f"[J] worker {i} exited with {p.returncode}")
            check(time.perf_counter() < deadline,
                  f"[J] workers still running after {J_TIMEOUT:.0f} s")
            time.sleep(0.2)
        codes = [p.returncode for p in procs]
        check(codes == [0] * len(procs), f"[J] worker exit codes {codes}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _j_references(device, host) -> dict:
    """The one-process runs J's workers are held to, on the same systems
    and plans: f64 Jacobi-CG and f32 BSGShardedOperator Jacobi-CG over the
    4 parts of J1's plan, the slab CG over J3's plan; and the three
    collectives over the 4 parts in one process."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        BSGShardedOperator,
        ShardedOperator,
        build_halo_plan,
        make_device_mesh,
        sharded_cg_solve,
        slab_cg_solve,
    )

    sy, owner = host["hex"]
    plan = build_halo_plan(sy.A, owner, J_PARTS)
    mesh = make_device_mesh(J_PARTS, [device])
    op = ShardedOperator.from_plan(plan, mesh)
    b = op.put_vector(sy.b)
    r1, ms1 = _timed(lambda: sharded_cg_solve(
        op, b, torch.zeros_like(b), precond_diag=_jacobi(op), tol=1e-8,
        maxiter=20000), device)
    bop = BSGShardedOperator.from_plan(plan, mesh, dtype=np.float32)
    b32 = bop.put_vector(sy.b)
    r2, ms2 = _timed(lambda: sharded_cg_solve(
        bop, b32, torch.zeros_like(b32), precond_diag=_jacobi(bop), tol=1e-6,
        maxiter=20000), device)
    sy3, plan3, b3 = host["tet"]
    (x3, r3), ms3 = _timed(lambda: slab_cg_solve(
        plan3, b3, np.zeros_like(b3), tol=1e-6, maxiter=20000, mesh=mesh),
        device)
    for tag, r in (("J1", r1), ("J2", r2), ("J3", r3)):
        check(r.converged, f"[{tag}] the one-process solve did not converge")
    log(f"[J] one process: J1 {r1.iterations} iterations ({ms1:.1f} ms), "
        f"J2 {r2.iterations} ({ms2:.1f} ms), J3 {r3.iterations} "
        f"({ms3:.1f} ms)")
    return dict(J1=dict(iterations=r1.iterations, solve_ms=ms1),
                J2=dict(iterations=r2.iterations, solve_ms=ms2,
                        storage=bop.parts[0].storage),
                J3=dict(iterations=r3.iterations, solve_ms=ms3, x=x3),
                collectives_ms=_collective_ms(device, op, plan3))


def _within(a: int, b: int) -> bool:
    return abs(a - b) <= max(2, 0.02 * b)


def phase_j(device, cfg=None, out=OUT) -> dict:
    """J: two worker processes (``--phase-j-worker``) over gloo on the one
    card, held to the one-process runs of this process.  The workers run
    while this process builds the host systems; its device work starts
    once they have ended."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.io import (
        box_mesh,
        read_exodus,
        write_exodus,
    )
    from domain_decomposed_pde_solver_tpu_torch.io.exodus import (
        read_exodus_node_data,
    )
    from domain_decomposed_pde_solver_tpu_torch.io.mesh import (
        boundary_value_from_sets,
    )
    from domain_decomposed_pde_solver_tpu_torch.models import (
        assemble_heat_system,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel import partition_rcb

    t0 = time.perf_counter()
    cfg = {**J_FULL, **(cfg or {})}
    n = cfg["hex_box"]
    cfg.setdefault("hex_exo", f"box{n}_hex8.exo")
    out.mkdir(parents=True, exist_ok=True)
    exo = out / cfg["hex_exo"]
    if not exo.exists():
        write_exodus(str(exo), box_mesh(n, n, n, "HEX8"))
    rendezvous = out / "phase_j.rendezvous"
    for f in [*out.glob("phase_j.rank*.json"), *out.glob("j3_*"),
              rendezvous]:
        f.unlink(missing_ok=True)
    addr = f"file://{rendezvous}"
    sys.stdout.flush()
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__)), "--phase-j-worker",
         str(r), str(J_WORLD), addr, str(out), json.dumps(cfg)], cwd=REPO)
        for r in range(J_WORLD)]
    deadline = time.perf_counter() + J_TIMEOUT
    try:
        # The host side of the references, while the workers run: the
        # global system and the RCB owner of every free row (the same
        # function of the node coordinates the workers compute), J3's.
        sy = assemble_heat_system(read_exodus(str(exo)))
        num_nodes, coords, node_sets = read_exodus_node_data(str(exo))
        is_bnd, _ = boundary_value_from_sets(num_nodes, node_sets)
        owner = partition_rcb(coords[~is_bnd], J_PARTS).astype(np.int32)
        host = dict(hex=(sy, owner), tet=_tet_system(cfg))
    finally:
        _wait_workers(procs, deadline)
    t_workers = time.perf_counter() - t0
    w = [json.loads((out / f"phase_j.rank{r}.json").read_text())
         for r in range(J_WORLD)]
    refs = _j_references(device, host)
    ks = J_PARTS // J_WORLD
    for tag in ("J1", "J2", "J3"):
        its = {r[tag]["iterations"] for r in w}
        check(len(its) == 1, f"[{tag}] the processes stopped at {its}")
    for r in w:
        j1, j2, j3 = r["J1"], r["J2"], r["J3"]
        check(abs(j1["iterations"] - refs["J1"]["iterations"]) <= 1,
              f"[J1] rank {r['rank']}: {j1['iterations']} iterations, one "
              f"process {refs['J1']['iterations']}")
        check(j2["storage"] == refs["J2"]["storage"], "[J2] storage differs")
        check(_within(j2["iterations"], refs["J2"]["iterations"]),
              f"[J2] rank {r['rank']}: {j2['iterations']} iterations, one "
              f"process {refs['J2']['iterations']}")
        check(_within(j3["iterations"], refs["J3"]["iterations"]),
              f"[J3] rank {r['rank']}: {j3['iterations']} iterations, one "
              f"process {refs['J3']['iterations']}")
        check(j2["parts"] == ks and j1["local_parts"] == ks,
              f"[J] rank {r['rank']} holds {j2['parts']} parts")
    check(w[0]["J1"].get("bit_identical") is True,
          "[J1] rank 0 did not check its blocks")
    xs = [np.load(out / f"j3_x.rank{r}.npy") for r in range(J_WORLD)]
    check(all(np.array_equal(xs[0], x) for x in xs[1:]),
          "[J3] the processes' answers differ")
    x1 = refs["J3"].pop("x")
    rel = float(np.linalg.norm(xs[0] - x1) / np.linalg.norm(x1))
    check(rel <= 1e-5, f"[J3] answer {rel:.3e} from one process's")
    blocks = {}
    for r in range(J_WORLD):
        with np.load(out / f"j3_ck.proc{r}.npz") as z:
            blocks.update({int(key.rsplit("__", 1)[1]): z[key]
                           for key in z.files})
    ck = np.concatenate([blocks[i] for i in sorted(blocks)])
    check(sorted(blocks) == list(range(J_PARTS)) and np.array_equal(
        ck, np.load(out / "j3_iterate.npy")),
        "[J3] the checkpoint does not reassemble the iterate")
    errs = {}
    for r in w:
        for key, e in r.pop("errs").items():
            errs[key] = max(errs.get(key, 0.0), e)
    wall = time.perf_counter() - t0
    log(f"[J] passed: J1 {[r['J1']['iterations'] for r in w]} / "
        f"{refs['J1']['iterations']} iterations, J2 "
        f"{[r['J2']['iterations'] for r in w]} / {refs['J2']['iterations']}, "
        f"J3 {[r['J3']['iterations'] for r in w]} / "
        f"{refs['J3']['iterations']} (answer {rel:.2e} from one process's); "
        f"workers {t_workers:.1f} s, phase {wall:.1f} s")
    return dict(workers=w, one_process=refs, j3_relerr=rel,
                checkpoint_rows=sorted(blocks), errs=errs,
                workers_s=t_workers, wall_s=wall)


def phase_j_launches(run_j: dict, name: str) -> dict:
    """One kernel's launches in each worker's counted J2 solve."""
    return {f"J2 rank {r['rank']}": r["J2"]["counts"][name]["launches"]
            for r in run_j["workers"]}


def phase_j_process(result: str) -> int:
    """Phase J in a process of its own (``python3 chip_smoke.py --phase-j
    RESULT``, started by :func:`run_phase_j`, or alone): build the kernels
    (the workers load them), run :func:`phase_j` and write its record to
    ``RESULT``; every line it logs carries the card's name and power
    limit."""
    global LOG_TAG
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    _kernels.build_kernels()  # the workers load them
    card = card_line()
    LOG_TAG = f" [{card}]"
    rec = phase_j(torch.device("cuda", 0))
    rec["card"] = card
    pathlib.Path(result).write_text(json.dumps(rec))
    return 0


def run_phase_j(timeout: float = 900.0) -> dict:
    """Run :func:`phase_j_process` in a child process on the same card and
    return its record; fails if the child does."""
    result = OUT / "phase_j.json"
    result.unlink(missing_ok=True)
    OUT.mkdir(parents=True, exist_ok=True)
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, str(pathlib.Path(__file__)),
                           "--phase-j", str(result)], cwd=REPO,
                          timeout=timeout)
    check(proc.returncode == 0 and result.exists(),
          f"[J] the phase J process exited with {proc.returncode}")
    return json.loads(result.read_text())


# ---------------------------------------------------------------------------
# D. Kernels against their plain versions
# ---------------------------------------------------------------------------


def _compare(name, y, y_ref, tol, errs, key, mask=None, tag="D") -> None:
    import torch

    sync(y.device)
    check(tuple(y.shape) == tuple(y_ref.shape), f"{name}: shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    diff = (y.double() - y_ref.double()).abs().max().item()
    rel = diff / max(y_ref.double().abs().max().item(), 1e-300)
    log(f"[{tag}] {name}: {y.numel()} entries, {str(y.dtype)[6:]}, max rel "
        f"err {rel:.3e} (limit {tol:.0e})")
    check(rel <= tol, f"[{tag}] {name}: kernel disagrees with plain ({rel:.3e})")
    if mask is not None:
        check(not bool(torch.any(y[mask])), f"[{tag}] {name}: a pad slot is not 0")
    errs[key] = max(errs.get(key, 0.0), diff)


def dia_compare(device, rng, errs, label, A, name, tol, tag="D") -> None:
    """Kernel 4's default launch on ``A`` against its plain version; on the
    card, every compiled instance for the shape, the run-time loop and
    every block bit-identical to it."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
    from domain_decomposed_pde_solver_tpu_torch.ops.dia_kernel import (
        dia_matvec_plain,
    )

    x = torch.as_tensor(rng.normal(size=A.n_pad), dtype=getattr(torch, name),
                        device=device)
    y = A.matvec(x)
    _compare(f"DIA {label} ({A.ndiags} diagonals, {A.n_pad} rows, "
             f"{str(A.data.dtype)[6:]} storage)", y,
             dia_matvec_plain(A, x), tol, errs, "dia_spmv", tag=tag)
    if device.type != "cuda":
        return
    default = _kernels.dia_launch_shape(A.n_pad, A.ndiags)
    shapes = [_kernels.DiaLaunch(i, blk)
              for i in sorted({default.instance, 0})
              for blk in _kernels.DIA_BLOCKS]
    for sh in shapes:
        ys = _kernels.dia_spmv_launch(A.data, A.offsets_array, x, shape=sh)
        sync(device)
        check(torch.equal(ys, y), f"[{tag}] DIA {label}: {sh} is not "
              f"bit-identical to the default launch {default}")
    log(f"[{tag}] DIA {label}: {len(shapes)} instances x blocks "
        f"bit-identical to the default {default}")


def sell_compare(device, rng, errs, label, op, tol, tag="D",
                 dtype=None) -> None:
    """Kernel 1 on the sliced-ELL ``op`` against its plain version, with
    vectors of ``dtype``, by default the operator's vector type (float64
    for float64 storage, else float32)."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import bsg_spmv, spmv_plain

    x = torch.as_tensor(rng.normal(size=op.x_len), dtype=dtype or op.dtype,
                        device=device)
    _compare(f"sliced ELL {label} ({op.n_pad} rows, {op.n_slots} slots, "
             f"{op.storage} storage)", bsg_spmv(op, x), spmv_plain(op, x),
             tol, errs, "sell_spmv", tag=tag)


def operator_compare(device, errs, label, A, M, tag) -> None:
    """Every kernel-backed operator of a solve against its plain version:
    the fine operator, each AMG level's operator and its sliced-ELL
    transfers, at f64 (``TOL_F64``)."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import BSGMatrix
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import DIAMatrix

    rng = np.random.default_rng(1)
    ops = [("fine operator", A)]
    for i, lvl in enumerate(M.levels):
        if lvl.A is not A:
            ops.append((f"AMG level {i}", lvl.A))
        for t in ("G", "GT"):
            if isinstance(getattr(lvl.P, t, None), BSGMatrix):
                ops.append((f"AMG level {i} transfer {t}", getattr(lvl.P, t)))
    for name, op in ops:
        if isinstance(op, DIAMatrix):
            dia_compare(device, rng, errs, f"{label} {name}", op, "float64",
                        TOL_F64, tag)
        elif isinstance(op, BSGMatrix):
            sell_compare(device, rng, errs, f"{label} {name}", op, TOL_F64,
                         tag)


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


def _random_laplacian(n: int, deg: int, seed: int, shift: float = 0.5):
    """Random graph Laplacian plus ``shift`` on the diagonal (SPD), as
    SciPy CSR."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    m = n * deg // 2
    u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = u != v
    u, v = u[keep], v[keep]
    M = sp.coo_matrix((np.ones(2 * u.size), (np.r_[u, v], np.r_[v, u])),
                      shape=(n, n)).tocsr()
    M.data[:] = -1.0
    M.setdiag(0)
    M.eliminate_zeros()
    M.setdiag(-np.asarray(M.sum(axis=1)).ravel() + shift)
    M = M.tocsr()
    M.sort_indices()
    return M


def compare_phase(device, run_a, run_b, run_c, run_d1, run_d2) -> dict:
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import bsg_spmv, spmv_plain
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import dia_from_csr

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
    hex8 = None
    for shape, elem in (((130, 12, 12), "TETRA4"), ((40, 40, 40), "HEX8")):
        sy, A = _pad_operator(shape, elem, device)
        pad_cases(f"box_mesh{shape} {elem} mxp={A.mxp} period={A.period}",
                  A, sy)
        hex8 = sy.A  # the last: a 27-point stencil for the DIA kernel

    levels = run_a["report"]["precond"].levels
    L1, L2 = levels[1].A, levels[2].A

    def dia_case(label, A, name, tol):
        dia_compare(device, rng, errs, label, A, name, tol)

    dia_case("level 1 of path A", L1, "float32", TOL_F32)
    dia_case("level 1 of path A", L1, "float64", TOL_F64)
    dia_case("level 2 of path A", L2, "float32", TOL_F32)
    dia_case("fine operator of the default route", run_b["report"]["operator"],
             "float64", TOL_F64)
    dia_case("HEX8 box_mesh(40, 40, 40)", dia_from_csr(
        hex8, dtype=torch.float32, device=device), "float32", TOL_F32)
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
    compare_values(device, run_c, run_d1, run_d2, errs, vec)
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

    # Kernel 5: the fused solve against its plain recurrence, in both
    # instances, at the sizes of path D1 and at the cluster's edges.
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        _inverse_diagonal,
        fused_cg_plain,
        fused_cg_plan,
        fused_cg_solve,
    )

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
    from domain_decomposed_pde_solver_tpu_torch.ops.csr import CSRMatrix

    cases = {label: (run_d1[label]["A"], run_d1[label]["b"], want)
             for label, want in (("833k", "grid"), ("16k", "cluster"))}
    for cells, want in ((5, "cluster"), (10, "cluster")):
        sy, A = _refined_system(cells, device)
        cases[f"refined {cells}^3, {A.n_pad} rows"] = (
            A, A.put_vector(sy.b, dtype=torch.float32), want)
    S = _random_laplacian(16_385, 6, 4)  # 17 CTAs: past the cluster
    A = bsg_from_csr(CSRMatrix(indptr=S.indptr.astype(np.int64),
                               indices=S.indices.astype(np.int64),
                               data=S.data, shape=S.shape), device=device)
    xt = np.random.default_rng(5).standard_normal(S.shape[0])
    cases[f"random graph, {A.n_pad} rows"] = (
        A, A.put_vector(S @ xt, dtype=torch.float32), "grid")
    for label, (A, b, want) in cases.items():
        check(fused_cg_plan(A).instance == want,
              f"[D] fused CG {label}: not the {want} instance")
        entry = _fused_entry_name(want, A)
        before = _kernels.FUSED_CG.by_entry[entry]
        rf = fused_cg_solve(A, b, tol=PCG_TOL, maxiter=PCG_MAXITER)
        again = fused_cg_solve(A, b, tol=PCG_TOL, maxiter=PCG_MAXITER)
        rp = fused_cg_plain(A, b, torch.zeros_like(b), _inverse_diagonal(A),
                            tol=PCG_TOL, maxiter=PCG_MAXITER)
        sync(device)
        if device.type == "cuda":
            check(_kernels.FUSED_CG.by_entry[entry] == before + 2,
                  f"[D] fused CG {label}: {entry} was not launched")
        diff = (rf.x.double() - rp.x.double()).abs().max().item()
        rel = diff / rp.x.double().abs().max().item()
        log(f"[D] fused CG {label} ({want} instance, {A.storage} values): "
            f"kernel {rf.iterations} "
            f"iterations, plain {rp.iterations}; max rel diff of x {rel:.3e} "
            f"(limit 1e-4); two runs bit-identical: "
            f"{torch.equal(again.x, rf.x)}")
        check(abs(rf.iterations - rp.iterations) <= 2,
              f"[D] fused CG {label}: iterations differ by more than 2")
        check(rel <= 1e-4, f"[D] fused CG {label}: x differs by {rel:.3e}")
        check(again.iterations == rf.iterations and torch.equal(again.x, rf.x),
              f"[D] fused CG {label}: two runs differ")
        errs["fused_cg"] = max(errs.get("fused_cg", 0.0), diff)
    compare_restarts(device)


def with_storage(A, dtype):
    """The sliced-ELL operator ``A`` with its values stored as ``dtype``:
    the same slots and numbering, each value converted (exactly, where it
    fits the type)."""
    import dataclasses

    return dataclasses.replace(A, vals=A.vals.to(dtype), _slot_key=None)


def _csr_of(S):
    """A port CSR matrix from SciPy CSR."""
    import numpy as np

    from domain_decomposed_pde_solver_tpu_torch.ops.csr import CSRMatrix

    return CSRMatrix(indptr=S.indptr.astype(np.int64),
                     indices=S.indices.astype(np.int64),
                     data=S.data.astype(np.float64), shape=S.shape)


def _general_matrix(n: int, seed: int):
    """SPD, values neither integers nor bfloat16: a random Laplacian with
    its entries scaled by 1 + U(0, 0.01), symmetrised."""
    import numpy as np

    S = _random_laplacian(n, 8, seed)
    S.data = S.data * (1.0 + 0.01 * np.random.default_rng(seed).random(
        S.data.size))
    S = ((S + S.T) * 0.5).tocsr()
    S.sort_indices()
    return S


# The value storages that hold each operator's values exactly.
EXACT_STORAGES = {"int8": ("float32", "bfloat16", "int8"),
                  "bfloat16": ("float32", "bfloat16"),
                  "float32": ("float32",)}


def compare_values(device, run_c, run_d1, run_d2, errs, vec) -> None:
    """Kernels 1, 2 and 5 with int8 and bfloat16 values (adds to ``errs``).

    Kernels 1 and 2 on path C's operator (the graph Laplacian: int8 by
    ``storage="auto"``), a random bfloat16-exact Laplacian and a matrix of
    neither, in every storage that holds its values exactly, with f32 and
    f64 vectors: each launch within the tolerance of its plain version and
    bit-identical to the float32-storage launch (the same products in the
    same order).  Kernel 5 on path D1's int8 operators at 833k (grid
    instance) and 16k (cluster): the float32 and bfloat16 copies take the
    same instance, the same iterations and the same answer bit for bit."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import (
        _STORAGE,
        bsg_from_csr,
        bsg_spmv,
        spmv_plain,
    )
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        fused_cg_plan,
        fused_cg_solve,
    )

    A, R = run_c["solver"].operator, run_d2["R"]
    check(A.storage == R.storage == "int8",
          f"[D] path C's operators store {A.storage} / {R.storage}")
    cases = [("path C", A, R)]
    for label, S in (("random bf16-exact Laplacian", _random_laplacian(
            200_000, 8, 11)), ("random f32-only", _general_matrix(200_000, 12))):
        csr = _csr_of(S)
        D = bsg_from_csr(csr, device=device)
        cases.append((label, D, bsg_from_csr(
            csr, perm=D.perm.cpu().numpy(), layout="ragged", chunk=16,
            device=device)))
    check([c[1].storage for c in cases] == ["int8", "bfloat16", "float32"],
          f"[D] storage='auto' gave {[c[1].storage for c in cases]}")
    for label, dense, ragged in cases:
        for name, tol in (("float32", TOL_F32), ("float64", TOL_F64)):
            x = vec(dense.n_pad, getattr(np, name))
            for layout, op0, kernel in (
                    ("dense", dense, _kernels.SELL_SPMV),
                    ("ragged", ragged, _kernels.SELL_CHUNKED_SPMV)):
                ref = None
                for s in EXACT_STORAGES[dense.storage]:
                    op = with_storage(op0, _STORAGE[s])
                    entry = (f"ddps_{kernel.name}_{_kernels._NAME[op.vals.dtype]}"
                             f"_{_kernels._NAME[x.dtype]}")
                    before = kernel.by_entry[entry]
                    y = bsg_spmv(op, x)
                    _compare(f"{kernel.name} {label} ({layout}, {s} values, "
                             f"{op.n_slots} slots)", y, spmv_plain(op, x),
                             tol, errs, kernel.name)
                    if device.type == "cuda":
                        check(kernel.by_entry[entry] == before + 1,
                              f"[D] {entry} was not launched")
                    if ref is None:
                        ref = y
                    check(torch.equal(y, ref), f"[D] {kernel.name} {label} "
                          f"({layout}, {s} values, {name} vectors): not "
                          f"bit-identical to the float32-storage launch")
            log(f"[D] {label}, {name} vectors: kernels 1 and 2 bit-identical "
                f"across the storages {EXACT_STORAGES[dense.storage]}")
    for label in ("833k", "16k"):
        d = run_d1[label]
        Ai, b = d["A"], d["b"]
        check(Ai.storage == "int8", f"[D] fused CG {label}: {Ai.storage}")
        ri = d["fused"]
        plan = fused_cg_plan(Ai)
        for s in ("float32", "bfloat16"):
            F = with_storage(Ai, _STORAGE[s])
            check(fused_cg_plan(F).instance == plan.instance,
                  f"[D] fused CG {label}: {s} values take another instance")
            entry = _fused_entry_name(plan.instance, F)
            before = _kernels.FUSED_CG.by_entry[entry]
            rf = fused_cg_solve(F, b, tol=PCG_TOL, maxiter=PCG_MAXITER)
            sync(device)
            if device.type == "cuda":
                check(_kernels.FUSED_CG.by_entry[entry] == before + 1,
                      f"[D] fused CG {label}: {entry} was not launched")
            check(rf.iterations == ri.iterations and torch.equal(rf.x, ri.x),
                  f"[D] fused CG {label}: {s} values give {rf.iterations} "
                  f"iterations, int8 {ri.iterations}, or another answer")
        smem = ""
        if plan.instance == "cluster":
            ms, mw = plan.pack.max_slots, plan.pack.max_win
            smem = (f"; shared memory per CTA: int8 "
                    f"{_kernels.cluster_smem_bytes(ms, mw, 1)} B, bfloat16 "
                    f"{_kernels.cluster_smem_bytes(ms, mw, 2)} B, float32 "
                    f"{_kernels.cluster_smem_bytes(ms, mw, 4)} B of "
                    f"{_kernels.CLUSTER_SMEM_BUDGET} ({ms} slots, window {mw})")
        log(f"[D] fused CG {label} ({plan.instance} instance): int8, "
            f"bfloat16 and float32 values, {ri.iterations} iterations each, "
            f"answers bit-identical{smem}")


def compare_restarts(device) -> None:
    """Kernel 5 restarted from a converged iterate: the solve's own
    instance, the grid instance and the plain recurrence, each from the
    same iterate, beside the iterate's host relres and f32 rounding floor.
    The restart converges within one iteration of the plain one's, and
    stops at once where the iterate lies inside the tolerance by more than
    four floors."""
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import bsg_from_csr
    from domain_decomposed_pde_solver_tpu_torch.ops.csr import CSRMatrix
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        _inverse_diagonal,
        fused_cg_plain,
        fused_cg_plan,
        fused_cg_solve,
    )

    sy, A = _refined_system(10, device)
    restarts = {"refined 10^3": (sy.A, sy.b, A)}
    for n, deg, seed, shift in ((500, 8, 3, 1e-3), (600, 9, 5, 0.5)):
        S = _random_laplacian(n, deg, seed, shift)
        csr = CSRMatrix(indptr=S.indptr.astype(np.int64),
                        indices=S.indices.astype(np.int64), data=S.data,
                        shape=S.shape)
        xt = np.random.default_rng(seed + 7).standard_normal(n)
        restarts[f"graph {n} (shift {shift:g})"] = (
            csr, (S @ xt).astype(np.float32),
            bsg_from_csr(csr, reorder=True, device=device))
    for label, (H, b_host, A) in restarts.items():
        b = A.put_vector(b_host, dtype=torch.float32)
        invd = _inverse_diagonal(A)
        done = fused_cg_solve(A, b, tol=PCG_TOL, maxiter=PCG_MAXITER)
        warm = fused_cg_solve(A, b, x0=done.x, tol=PCG_TOL,
                              maxiter=PCG_MAXITER)
        _xg, stats = _kernels.fused_cg_launch(A.slice_ptr, A.cols, A.vals, b,
                                              invd, done.x, PCG_TOL,
                                              PCG_MAXITER)
        grid_k, _rr, grid_conv, _r2 = stats.tolist()
        plain = fused_cg_plain(A, b, done.x, invd, tol=PCG_TOL,
                               maxiter=PCG_MAXITER)
        u = A.get_vector(done.x)
        rr = host_relres(H, u, np.asarray(b_host, dtype=np.float64))
        fl = f32_floor(H, u, np.asarray(b_host, dtype=np.float64))
        log(f"[D] fused CG restart, {label} ({fused_cg_plan(A).instance} "
            f"instance): solve {done.iterations} iterations, recursive "
            f"relres {done.relres:.6e}; iterate's host relres {rr:.6e}, f32 "
            f"floor {fl:.3e} (tolerance {PCG_TOL:g}); restarted from it: "
            f"solve {warm.iterations}, grid instance {int(grid_k)}, plain "
            f"{plain.iterations} iterations")
        check(done.converged and warm.converged and plain.converged
              and grid_conv > 0, f"[D] fused CG restart {label}: not converged")
        check(warm.iterations <= plain.iterations + 1,
              f"[D] fused CG restart {label}: {warm.iterations} iterations, "
              f"plain {plain.iterations}")
        check(rr + 4 * fl > PCG_TOL or warm.iterations == 0,
              f"[D] fused CG restart {label}: an iterate inside the tolerance "
              f"did not stop at once")


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


def profile_cold(fn, scrub, kernel: str, reps: int = 20,
                 attempts: int = 5) -> float:
    """Device ms per call of the kernels whose name holds ``kernel``, with
    the 50 MB L2 flushed before each call (a 256 MB buffer rewritten),
    from the profiler: event timing of a launch this short would measure
    the host's dispatch.  A trace that lacks some of the launches (CUPTI
    now and then hands back an empty one) is taken again, up to
    ``attempts`` times; then CUDA events around each call, recorded after
    its flush, time it instead (the call is queued while the flush runs,
    so the span is the call's device time and its launch gap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                scrub.add_(1.0)
                fn()
            torch.cuda.synchronize()
        ev = [e for e in _device_events(prof) if kernel in e[0]]
        if len(ev) == reps:
            return sum(t - s for _n, s, t in ev) / 1e3 / reps
        log(f"profiler: cold trace {attempt + 1} held {len(ev)} launches")
        time.sleep(0.5)
    log(f"profiler: no complete cold trace of {kernel} in {attempts}; "
        f"CUDA events instead")
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        scrub.add_(1.0)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


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


def profile_device(fn, reps: int = 20, kernel: str = "",
                   per_call: int = 1, attempts: int = 5) -> dict:
    """torch.profiler (CUPTI) over ``reps`` calls after a warm-up: device
    time per call (the sum of its kernels, copies and fills), the union of
    its device intervals per call, the wall per call under the profiler,
    and device time by kernel name.  A trace with no device events at all
    (CUPTI now and then hands back an empty one), or, given ``kernel`` (a
    substring of the name of a kernel each call launches ``per_call``
    times), with another number of its launches than ``reps * per_call``
    (CUPTI now and then drops one), is taken again, up to ``attempts``
    times.  If none is whole, CUDA events around the ``reps`` calls give
    the device time instead (their span: device time and the gaps between
    launches); the busy time and the kernels are then not measured
    (``busy_ms`` None, ``kernels`` empty) and ``timed_by`` says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    want = reps * per_call
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = _device_events(prof)
        seen = sum(kernel in name for name, _s, _t in ev) if kernel else want
        if ev and seen == want:
            break
        log(f"profiler: trace {attempt + 1} recorded {len(ev)} device "
            f"events, {seen if kernel else 'any'} of {want} launches of "
            f"{kernel or 'any kernel'}")
        time.sleep(0.5)
    else:
        log(f"profiler: no whole trace in {attempts}; CUDA events instead "
            f"(busy time, idle share and kernels not measured)")
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return dict(device_ms=start.elapsed_time(stop) / reps, busy_ms=None,
                    wall_ms=wall * 1e3 / reps, kernels={}, timed_by="events")
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
        timed_by="profiler",
    )


def idle_share(p: dict):
    """1 - busy / wall of a :func:`profile_device` result; None where
    events timed it."""
    return None if p["busy_ms"] is None else 1.0 - p["busy_ms"] / p["wall_ms"]


def replay_record(p: dict) -> dict:
    """A profiled replay's device, busy and wall ms, idle share and how it
    was timed."""
    return dict(device_ms=p["device_ms"], busy_ms=p["busy_ms"],
                wall_ms=p["wall_ms"], idle_share=idle_share(p),
                timed_by=p["timed_by"])


def replay_text(rec: dict) -> str:
    """:func:`replay_record` for the log."""
    if rec["busy_ms"] is None:
        return (f"device {rec['device_ms']:.3f} ms (CUDA events: the "
                f"profiler gave no whole trace; busy time and idle share "
                f"not measured) of {rec['wall_ms']:.3f} ms wall")
    return (f"device {rec['device_ms']:.3f} ms, busy {rec['busy_ms']:.3f} ms "
            f"of {rec['wall_ms']:.3f} ms wall (idle share "
            f"{rec['idle_share']:.3f})")


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


def sell_bytes(A) -> int:
    """Compulsory bytes of one sliced-ELL product in f32 vectors: every
    slot's column (4 B) and value read once, the slice pointers, x read
    once and y written once."""
    return (A.n_slots * (4 + A.vals.element_size())
            + A.slice_ptr.numel() * 8 + A.x_len * 4 + A.n_pad * 4)


def timing_phase(device, card, run_a, run_b, run_c, run_d1, run_d2) -> dict:
    import numpy as np
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import bsg_spmv, spmv_plain

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
    k3["depths"] = time_pad_depths(device, card, {"1M": A}, rng, scrub)
    del scrub

    rec.update(time_dia(device, card, run_a, run_b, rng))

    # Kernel 1: slice 1's fine operator, in the storage storage="auto"
    # keeps (int8), beside the same slots with float32 values.
    solver = run_c["solver"]
    Af = solver.operator
    F32 = with_storage(Af, torch.float32)
    csr = solver.system.A
    x = torch.from_numpy(rng.normal(size=Af.n_pad).astype(np.float32)).to(device)
    perm = Af.perm
    xo = x[perm].contiguous()  # original order: the same product
    Acsr = _csr_tensor(csr.indptr, csr.indices, csr.data, csr.n_cols,
                       torch.float32, device)
    t = _measure({
        "kernel": lambda: bsg_spmv(Af, x),
        "f32_values": lambda: bsg_spmv(F32, x),
        "plain": lambda: spmv_plain(Af, x),
        "library": lambda: Acsr @ xo,
    })
    nbytes = sell_bytes(Af)
    b_ms, b_by = bound(nbytes, 2 * Af.n_slots)
    f32_ms, _ = bound(sell_bytes(F32), 2 * Af.n_slots)
    log(f"[E] sliced ELL fine ({Af.n_pad} rows, {Af.n_slots} slots, "
        f"{Af.storage} values, f32 vectors), device ms per call: kernel "
        f"{t['kernel']['device_ms']}, the same slots with f32 values "
        f"{t['f32_values']['device_ms']} (bound {f32_ms} ms, "
        f"{sell_bytes(F32) / 1e6:.2f} MB), plain {t['plain']['device_ms']}, "
        f"cuSPARSE CSR ({csr.nnz} nnz) {t['library']['device_ms']}; events "
        f"back to back: {json.dumps({k: v['events_ms'] for k, v in t.items()})}"
        f"; bound {b_ms} ms by {b_by} ({nbytes / 1e6:.2f} MB) [{card}]")
    rec["sell_spmv"] = dict(
        ms=t["kernel"]["device_ms"], plain_ms=t["plain"]["device_ms"],
        library_ms=t["library"]["device_ms"], bound_ms=b_ms, bound_by=b_by,
        storage=Af.storage, f32_values_ms=t["f32_values"]["device_ms"],
        f32_values_bound_ms=f32_ms,
        events_ms={k: v["events_ms"] for k, v in t.items()})
    rec["solve_a_warm"] = warm_solve_breakdown(card, run_a)
    rec.update(time_chunked(device, card, run_c, run_d2, rec["sell_spmv"],
                            nbytes))
    rec.update(time_fused(card, run_d1))
    return rec


def time_dia(device, card, run_a, run_b, rng) -> dict:
    """Kernel 4 on levels 1 and 2 of path A, path B's operator and the 1M
    fine operator in bf16/f64 (the default route's at the BASELINE's
    size): its default launch beside its launch floor (``noop``: a kernel
    that does nothing, on the same grid and block) and one dependent load
    (``copy``: n values read and written on the same grid), every launch
    shape of its instance, the run-time loop at the default shape; the
    plain version and cuSPARSE on level 1 and the 1M operator.  Launches
    here do not count."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import dia_from_csr
    from domain_decomposed_pde_solver_tpu_torch.ops.dia_kernel import (
        dia_matvec_plain,
    )

    levels = run_a["report"]["precond"].levels
    fine = dia_from_csr(run_a["report"]["system"].A, dtype=torch.float64,
                        device=device)
    shapes = (("level 1", levels[1].A, "float32", True),
              ("level 2", levels[2].A, "float32", False),
              ("path B", run_b["report"]["operator"], "float64", False),
              ("1M fine", fine, "float64", True))
    rec = {}
    for label, D, name, yardsticks in shapes:
        dt = getattr(torch, name)
        x = torch.as_tensor(rng.normal(size=D.n_pad), dtype=dt, device=device)
        offs = D.offsets_array
        default = _kernels.dia_launch_shape(D.n_pad, D.ndiags)

        def launch(sh):
            return lambda: _kernels.dia_spmv_launch(D.data, offs, x, shape=sh)

        # Clocks up after the host-side build of the operator: a few ms of
        # launches before the first timed one.
        for _ in range(400):
            D.matvec(x)
        k4 = "dia_spmv_kernel"
        ms = profile_device(lambda: D.matvec(x), kernel=k4)["device_ms"]
        floor = profile_device(lambda: _kernels.dia_floor_launch(
            "noop", x, default), kernel="noop_kernel")["device_ms"]
        # The launch before the size rule: 256 threads, one row each.
        floor_256 = profile_device(lambda: _kernels.dia_floor_launch(
            "noop", x, _kernels.DiaLaunch(0, 256)),
            kernel="noop_kernel")["device_ms"]
        copy = profile_device(lambda: _kernels.dia_floor_launch(
            "copy", x, default), kernel="copy_kernel")["device_ms"]
        loop = profile_device(launch(_kernels.DiaLaunch(
            0, default.block)), kernel=k4)["device_ms"]
        sweep = {str(blk): profile_device(launch(_kernels.DiaLaunch(
            default.instance, blk)), kernel=k4)["device_ms"]
                 for blk in _kernels.DIA_BLOCKS}
        vb = x.element_size()
        nbytes = D.ndiags * D.n_pad * D.data.element_size() + 2 * D.n_pad * vb
        b_ms, b_by = bound(nbytes, 2 * D.ndiags * D.n_pad)
        r = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, launch_floor_ms=floor,
                 launch_floor_256_ms=floor_256, copy_ms=copy, loop_ms=loop,
                 sweep_ms=sweep,
                 instance=default.instance, block=default.block,
                 ndiags=D.ndiags, n=D.n_pad,
                 storage=str(D.data.dtype)[6:], vectors=name)
        line = (f"[E] DIA {label} ({D.ndiags} diagonals, {D.n_pad} rows, "
                f"{r['storage']} storage, {name} vectors), device ms per "
                f"call: kernel {ms} ({default}; {ms / floor:.2f}x its launch "
                f"floor), launch floor {floor} (256-thread blocks "
                f"{floor_256}), one-load copy {copy}, run-time loop {loop}; "
                f"by block "
                f"{json.dumps(sweep)}; bound {b_ms} ms by {b_by}")
        if yardsticks:
            ip, ix, dv = _dia_csr(D)
            Dcsr = _csr_tensor(ip, ix, dv, D.n_rows, dt, device)
            xr = x[: D.n_rows].contiguous()
            t = _measure({
                "kernel": lambda: D.matvec(x),
                "plain": lambda: dia_matvec_plain(D, x),
                "library": lambda: Dcsr @ xr,
            })
            r.update(plain_ms=t["plain"]["device_ms"],
                     library_ms=t["library"]["device_ms"],
                     events_ms={k: v["events_ms"] for k, v in t.items()})
            line += (f"; plain {r['plain_ms']}, cuSPARSE CSR "
                     f"{r['library_ms']}; events back to back: "
                     f"{json.dumps(r['events_ms'])}")
        log(line + f" [{card}]")
        rec[f"dia_spmv/{label}"] = r
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


def time_pad_depths(device, card, ops, rng, scrub) -> dict:
    """Kernel 3 in f32 at every z-depth of PAD_DEPTHS on each pad-stencil
    operator of ``ops`` (label -> operator: path A's, phase G's 10M box),
    each against the plain version; device ms per call, and with L2
    flushed for the launch's own choice.  Launches here do not count."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels

    out = {}
    for label, op in ops.items():
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
    R32 = with_storage(R, torch.float32)
    csr = run_c["solver"].system.A
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=R.n_pad).astype(np.float32)).to(device)
    xo = x[R.perm].contiguous()
    Acsr = _csr_tensor(csr.indptr, csr.indices, csr.data, csr.n_cols,
                       torch.float32, device)
    t = _measure({
        "kernel": lambda: bsg_spmv(R, x),
        "f32_values": lambda: bsg_spmv(R32, x),
        "plain": lambda: spmv_plain(R, x),
        "library": lambda: Acsr @ xo,
    })
    b_ms, b_by = k1["bound_ms"], k1["bound_by"]
    ratio = R.n_slots / run_c["solver"].operator.n_slots
    ms = t["kernel"]["device_ms"]
    log(f"[E] chunked ELL fine ({R.n_pad} rows, {R.n_chunks} chunks of 16, "
        f"{R.wide.numel()} spread one per warp, {R.n_slots} slots, slot "
        f"ratio {ratio:.4f}, {R.storage} values, f32 vectors), device ms per "
        f"call: kernel {ms} (the same slots with f32 values "
        f"{t['f32_values']['device_ms']}; kernel 1 "
        f"on the dense layout {k1['ms']}: {ms / k1['ms']:.3f}x), plain "
        f"{t['plain']['device_ms']}, cuSPARSE CSR "
        f"{t['library']['device_ms']} ({ms / t['library']['device_ms']:.3f}x)"
        f"; events back to back: "
        f"{json.dumps({k: v['events_ms'] for k, v in t.items()})}; bound "
        f"{b_ms} ms by {b_by} (kernel 1's, {k1_bytes / 1e6:.2f} MB) [{card}]")
    return {"sell_chunked_spmv": dict(
        ms=ms, plain_ms=t["plain"]["device_ms"],
        library_ms=t["library"]["device_ms"], bound_ms=b_ms, bound_by=b_by,
        slot_ratio=ratio, vs_kernel_1=ms / k1["ms"], storage=R.storage,
        f32_values_ms=t["f32_values"]["device_ms"],
        events_ms={k: v["events_ms"] for k, v in t.items()})}


def _wall_ms(fn, reps: int) -> list:
    """Host ms of each of ``reps`` calls, each ended by a synchronise."""
    import torch

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _fused_modes(A, b, plan, instance: str, iters: int) -> dict:
    """Device ms of one launch of ``instance`` in each measurement mode,
    ``iters`` iterations: ``barriers`` (the synchronisation floor: the
    launch, barriers and reductions of every iteration), ``matvec`` (and
    the matvec, with the cluster's window fills), ``solve``.  The
    measurement modes run on float32 values (their entries take no other;
    the same slots), the solve on the operator's own."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels

    zero = torch.zeros_like(b)
    f32 = with_storage(A, torch.float32).vals
    out = {}
    for mode in _kernels.FUSED_CG_MODES:
        vals = A.vals if mode == "solve" else f32
        if instance == "cluster":
            pk = plan.pack
            fn = (lambda m=mode, v=vals: _kernels.fused_cg_cluster_launch(
                v, pk.lcols, A.slice_ptr, pk.windows, pk.max_slots,
                pk.max_win, b, plan.invd, None, PCG_TOL, iters, mode=m))
        else:
            fn = (lambda m=mode, v=vals: _kernels.fused_cg_launch(
                A.slice_ptr, A.cols, v, b, plan.invd, zero, PCG_TOL,
                iters, mode=m))
        out[mode] = profile_device(fn, reps=3, kernel="fused_cg")["device_ms"]
    return out


def time_fused(card, run_d1) -> dict:
    """Kernel 5 per solve at both sizes: wall (host clock around the solve
    and a synchronise) and device time (profiler), beside its plain
    recurrence and, as the yardstick, the unfused loop on kernel 1; the
    instance's synchronisation floor and matvec-only time; at 16k the grid
    instance too.  Two bounds: ``bound_ms`` counts the function's
    compulsory bytes (operator, b, D^-1 and x0 read once, x written once)
    against its flops, as every kernel's bound here; ``streaming_bound_ms``
    the operator and nine vector passes read from device memory in every
    iteration, what a solve whose operator does not stay on chip moves."""
    import torch

    from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
    from domain_decomposed_pde_solver_tpu_torch.solvers import (
        cg_solve,
        fused_cg_solve,
    )
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        fused_cg_plain,
        fused_cg_plan,
    )

    rec = {}
    for label in ("833k", "16k"):
        d = run_d1[label]
        A, b, M = d["A"], d["b"], d["M"]
        zero = torch.zeros_like(b)
        plan = fused_cg_plan(A)
        invd = plan.invd
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
        prof = {k: profile_device(fns[k], reps=3 if k == "fused" else 1,
                                  kernel="fused_cg" if k == "fused" else "")
                for k in fns}
        iters = d["fused"].iterations
        modes = _fused_modes(A, b, plan, plan.instance, iters)
        extra = {}
        if plan.instance == "cluster":
            grid = _fused_modes(A, b, plan, "grid", iters)
            extra = dict(grid_ms=grid["solve"], grid_floor_ms=grid["barriers"],
                         grid_matvec_ms=grid["matvec"])
            _x, _st, active = _kernels.fused_cg_cluster_launch(
                A.vals, plan.pack.lcols, A.slice_ptr, plan.pack.windows,
                plan.pack.max_slots, plan.pack.max_win, b, invd, None,
                PCG_TOL, iters)
            extra.update(active_clusters=active, ctas=plan.pack.ctas,
                         max_slots=plan.pack.max_slots,
                         max_window=plan.pack.max_win)
        slot_b = 4 + A.vals.element_size()  # column and value
        per_iter = (A.n_slots * slot_b + A.slice_ptr.numel() * 8
                    + (A.x_len + VECTOR_PASSES * A.n_pad) * 4)
        setup = (A.n_slots * slot_b + 5 * A.n_pad * 4)  # A x0, b, x0, D^-1, r, p
        flops = iters * (2 * A.n_slots + 12 * A.n_pad)
        s_ms, _s_by = bound(iters * per_iter + setup, flops)
        once = (A.n_slots * slot_b + A.slice_ptr.numel() * 8
                + 4 * A.n_pad * 4)
        F32 = with_storage(A, torch.float32)
        f32_dev = profile_device(
            lambda: fused_cg_solve(F32, b, tol=PCG_TOL, maxiter=PCG_MAXITER),
            reps=3, kernel="fused_cg")["device_ms"]
        b_ms, b_by = bound(once, flops)
        dev = prof["fused"]["device_ms"]
        unf = prof["unfused"]
        idle = idle_share(unf)
        us = dev * 1e3 / iters
        log(f"[E] fused CG {label} ({A.n_pad} rows, {plan.instance} instance, "
            f"{A.storage} values, {iters} iterations; unfused "
            f"{d['unfused'].iterations}; the same slots with f32 values "
            f"{f32_dev} ms of device time): wall ms "
            f"per solve fused {walls['fused']}, unfused {walls['unfused']}, "
            f"plain {walls['plain']}; device ms per solve fused {dev} "
            f"({us:.2f} us per iteration), unfused {unf['device_ms']} (busy "
            f"{unf['busy_ms']} of {unf['wall_ms']} ms under the profiler, "
            f"idle share {idle}), plain {prof['plain']['device_ms']}; one "
            f"launch of the {plan.instance} instance by mode "
            f"{json.dumps(modes)} ms (synchronisation floor "
            f"{modes['barriers'] * 1e3 / iters:.2f} us per iteration); "
            f"{json.dumps(extra)}; bound {b_ms} ms by {b_by} (operator and "
            f"vectors once, {once / 1e6:.2f} MB), streaming bound {s_ms} ms "
            f"({s_ms * 1e3 / iters:.2f} us per iteration) [{card}]")
        rec[f"fused_cg/{label}"] = dict(
            ms=dev, plain_ms=prof["plain"]["device_ms"], bound_ms=b_ms,
            bound_by=b_by, streaming_bound_ms=s_ms, library_ms=None,
            instance=plan.instance, iterations=iters, us_per_iteration=us,
            storage=A.storage, f32_values_ms=f32_dev,
            floor_ms=modes["barriers"], matvec_mode_ms=modes["matvec"],
            solve_mode_ms=modes["solve"], wall_ms=walls["fused"],
            plain_wall_ms=walls["plain"],
            yardstick="unfused cg_solve + Jacobi on the sliced-ELL kernel",
            yardstick_ms=min(walls["unfused"]),
            yardstick_wall_ms=walls["unfused"],
            yardstick_device_ms=unf["device_ms"],
            yardstick_idle_share=idle,
            unfused_iterations=d["unfused"].iterations, **extra)
    return rec


# Profiled calls per replay of phase F: one for the second-long loops.
F_REPS = {"F1 transient": 1, "F2 resumable": 1, "F3 power": 1}


def time_phase_f(card, replays) -> dict:
    """Device time of each counted solve of phase F, run again under the
    profiler: the sum of its kernels, copies and fills, their union (busy),
    the wall under the profiler, the idle share 1 - busy / wall, and the
    time in the port's kernels (the DIA and sliced-ELL products).  A trace
    missing a launch of the port's kernel that the counted run made is
    taken again."""
    out = {}
    for label, (fn, counts) in replays.items():
        kernel, per_call = "", 1
        for name in ("dia_spmv", "sell_spmv"):
            if counts[name]["launches"]:
                kernel, per_call = f"{name}_kernel", counts[name]["launches"]
                break
        p = profile_device(fn, reps=F_REPS.get(label, 3), kernel=kernel,
                           per_call=per_call)
        ours = {k: v for k, v in p["kernels"].items()
                if "dia_spmv_kernel" in k or "sell_spmv_kernel" in k}
        rec = dict(replay_record(p),
                   port_kernels={k[:80]: v for k, v in ours.items()})
        log(f"[E] {label}: {replay_text(rec)}; port kernels (launches, ms) "
            f"{json.dumps(rec['port_kernels'])} [{card}]")
        out[label] = rec
    return out


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
    idle = idle_share(prof)
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
    run_f = run_phase_f()
    log(f"[F] done at {time.perf_counter() - t_start:.1f} s")
    run_g = run_phase_g()
    log(f"[G] done at {time.perf_counter() - t_start:.1f} s")
    run_h = run_phase_h(dict(
        c_iterations=run_c["res"][0].iterations,
        d1_iterations=run_d1["833k"]["unfused"].iterations,
        d1_floor=run_d1["833k"]["floor"],
        f3_eigenvalue=run_f["F3"]["eigenvalue"]))
    log(f"[H] done at {time.perf_counter() - t_start:.1f} s")
    mr_a = run_a["report"]["mixed"]
    run_i = run_phase_i(dict(a_sweeps=mr_a.refinements,
                             a_inner=mr_a.inner_iterations,
                             g_cg=run_g["cg"]["iterations"]))
    log(f"[I] done at {time.perf_counter() - t_start:.1f} s")
    run_j = run_phase_j()
    log(f"[J] done at {time.perf_counter() - t_start:.1f} s")

    # ---- D. kernels against plain versions (launches not counted) --------
    errs = compare_phase(device, run_a, run_b, run_c, run_d1, run_d2)
    for key, e in [*run_f.pop("errs").items(), *run_g.pop("errs").items(),
                   *run_h.pop("errs").items(), *run_i.pop("errs").items(),
                   *run_j.pop("errs").items()]:
        errs[key] = max(errs.get(key, 0.0), e)

    # ---- E. timing and records --------------------------------------------
    rec = timing_phase(device, card, run_a, run_b, run_c, run_d1, run_d2)
    g_time = run_g["timing"]
    rec["pad_stencil/float32"]["depths"].update(g_time.pop("pad_depths"))
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
        "slice6": run_f,
        "box10m": run_g,
        "domain_decomposed": run_h,
        "slab_engines": run_i,
        "multi_process": run_j,
        "timing": rec,
        "total_s": time.perf_counter() - t_start,
    }))
    main_shape = {"sell_spmv": ("sell_spmv", run_c["counts"]),
                  "pad_stencil": ("pad_stencil/float32", run_a["counts"]),
                  "dia_spmv": ("dia_spmv/level 1", run_a["counts"]),
                  "sell_chunked_spmv": ("sell_chunked_spmv", run_d2["counts"]),
                  "fused_cg": ("fused_cg/833k", run_d1["counts"])}
    # Kernels 4 and 5 list their instances, each at the shape that takes it.
    instances = {
        "dia_spmv": {k.split("/")[1]: {f: v for f, v in r.items()
                                       if f != "events_ms"}
                     for k, r in rec.items() if k.startswith("dia_spmv/")},
        "fused_cg": {r["instance"] + " (" + k.split("/")[1] + ")": {
            f: r[f] for f in ("ms", "bound_ms", "streaming_bound_ms",
                              "us_per_iteration", "floor_ms",
                              "matvec_mode_ms", "iterations", "grid_ms",
                              "grid_floor_ms", "active_clusters") if f in r}
            for k, r in rec.items() if k.startswith("fused_cg/")},
    }
    records = []
    for k in kernels:
        key, counts = main_shape[k.name]
        r = rec[key]
        extra = {f: r[f] for f in ("yardstick", "yardstick_ms", "slot_ratio",
                                   "vs_kernel_1", "cold_ms", "f64_ms",
                                   "f64_cold_ms", "launch_floor_ms",
                                   "copy_ms", "streaming_bound_ms")
                 if f in r}
        if k.name in instances:
            extra["instances"] = instances[k.name]
        extra["phase_f_launches"] = phase_f_launches(run_f, k.name)
        extra["phase_g_launches"] = {
            run: c.get(k.name, 0) for run, c in run_g["launches"].items()}
        extra["phase_h_launches"] = phase_h_launches(run_h, k.name)
        extra["phase_i_launches"] = phase_i_launches(run_i, k.name)
        extra["phase_j_launches"] = phase_j_launches(run_j, k.name)
        if k.name == "pad_stencil":
            # Phase I's instances: kernel 3 on every slab's window, f32 and
            # f64, at 1M (I2) and 10M (I3) over 4 parts.
            extra["phase_i_windows"] = {
                key: dict(max_abs_err=[
                    run_i[key[:2]]["window_errs"][f"part {p} {key[3:]}"]
                    for p in range(len(t["per_part"]))],
                    per_part=t["per_part"], exchange_ms=t["exchange_ms"],
                    exchange_device_ms=t["exchange_device_ms"],
                    matvec_ms=t["matvec_ms"])
                for key, t in run_i["timing"].items()
                if key.split()[-1] in ("float32", "float64")}
        if k.name == "sell_spmv":
            # Phase H's instances: each part's block of BSGShardedOperator.
            extra["phase_h_parts"] = {
                key: dict(max_abs_err=run_h["H2"][key[2:]]["max_abs_err"],
                          per_part=t["per_part"])
                for key, t in run_h["timing"].items()
                if key.startswith("P=")}
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
        if sys.argv[1:2] == ["--phase-f"]:
            sys.exit(phase_f_process(sys.argv[2]))
        if sys.argv[1:2] == ["--phase-g"]:
            sys.exit(phase_g_process(sys.argv[2]))
        if sys.argv[1:2] == ["--phase-h"]:
            sys.exit(phase_h_process(*sys.argv[2:4]))
        if sys.argv[1:2] == ["--phase-i"]:
            sys.exit(phase_i_process(*sys.argv[2:4]))
        if sys.argv[1:2] == ["--phase-j"]:
            sys.exit(phase_j_process(sys.argv[2]))
        if sys.argv[1:2] == ["--phase-j-worker"]:
            sys.exit(phase_j_worker(*sys.argv[2:7]))
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
