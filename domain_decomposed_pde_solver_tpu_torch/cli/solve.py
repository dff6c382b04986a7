"""Heat-equation solve driver — the ``BelosMueLuSolver`` executable.

Counterpart of the JAX package's ``cli/solve.py``: open -> assemble ->
dump A and B (``--outputPrefix``) -> decompose the mesh into
``max(2, nparts)`` partition blocks for the solution file -> solve -> dump
X.  The solve routes, chosen as JAX chooses them:

- ``--dtype float64 --precond amg --no-snapshots`` (CG, f32-exact
  operator): mixed-precision iterative refinement — f32 CG+AMG sweeps with
  the f64 residual on the device; on a structured box the operator is the
  pad-stencil one and AMG takes it as its fine level;
- otherwise a Krylov solve: ``--solver cg`` (a snapshot per iteration; with
  ``--checkpoint`` the resumable CG, which saves its state every
  ``--checkpoint-every`` iterations and continues from the file),
  ``gmres`` (a snapshot per restart cycle, or with
  ``--snapshot-every-iteration`` the reference's one-step
  solve/write/reset loop) or ``bicgstab``, preconditioned by
  none/jacobi/chebyshev/amg on the operator's own vector space, or by
  ilu0/ilut (the reference's GMRES+ILUT, ``BelosMueLuSolver.cpp:92-106``)
  on an identity-layout operator;
- ``--partitions N > 1``: the domain-decomposed solve over a halo plan
  (``parallel/``), every part on the one device, in JAX's branch order:
  CG with the global halo AMG for ``--precond amg`` (block-Schwarz AMG if
  that build fails, then Jacobi), else CG or GMRES with Jacobi or
  Chebyshev on the partitioned operator, whose local products run on the
  sliced-ELL kernel for f32 on a CUDA device (JAX: on a TPU); with
  snapshots, CG runs in chunks of ``--reportAfterIterations`` on one
  continuous recurrence.  As in JAX, ``--precond ilu0|ilut`` runs Jacobi
  there and ``--solver bicgstab`` runs CG.  A structured mesh with
  ``--precond amg`` (CG) takes the slab engines first, in JAX's order:
  f32 on a CUDA device the global AMG over z-slabs with the pad-stencil
  kernel on every slab (JAX: on a TPU), f64 with f32-exact values the
  f64 refinement over those slabs, otherwise the global AMG over slab DIA
  or lattice-stencil fine levels; when no slab hierarchy fits, the halo
  route above.

The solve runs on the card; ``--cpu`` runs it on the CPU.  ``--x64`` is
accepted for JAX's command lines and changes nothing (``--dtype`` sets the
precision); ``--debug-nans`` checks the answer and its reported residual
for NaN and Inf.

Usage::

    python -m domain_decomposed_pde_solver_tpu_torch.cli.solve \\
        --input mesh.exo --solution solution.exo --tolerance 1e-8 \\
        --dtype float64 --precond amg --no-snapshots
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional

import numpy as np

def _check_finite(x_host, relres) -> None:
    """``--debug-nans``: raise on NaN or Inf in the answer or its residual."""
    if not np.isfinite(float(relres)):
        raise FloatingPointError(f"--debug-nans: the solve reported a "
                                 f"residual of {float(relres)}")
    bad = int(np.count_nonzero(~np.isfinite(np.asarray(x_host))))
    if bad:
        raise FloatingPointError(f"--debug-nans: {bad} NaN or Inf values in "
                                 "the solve's answer")


def main(argv=None, report: Optional[dict] = None) -> int:
    """Run the driver; returns the exit code (0 when converged).

    ``report``: an optional dict that receives the run's objects —
    ``timer``, ``system``, ``operator``, ``precond``, ``result``, on the
    mixed route ``mixed`` (the :class:`MixedSolveResult`) and on the
    partitioned route ``plan`` (the :class:`HaloPlan`) — for callers that
    drive the CLI in process."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    from ..utils.config import add_solve_args, config_from_args

    add_solve_args(ap)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--x64", action="store_true",
                    help="accepted for the JAX package's command lines; "
                    "changes nothing here: --dtype sets the precision")
    ap.add_argument("--debug-nans", action="store_true",
                    help="check the answer and its reported residual for "
                    "NaN and Inf; raise FloatingPointError on one")
    args = ap.parse_args(argv)
    cfg = config_from_args(args)

    import torch

    from ..io import ExodusReadError, ExodusSolutionWriter, read_exodus
    from ..models.heat import assemble_heat_system
    from ..parallel import decompose_mesh
    from ..utils.device import resolve_device
    from ..utils.logging import print_csr_matrix, print_vector
    from ..utils.timers import PhaseTimer

    device = resolve_device("cpu" if args.cpu else None)
    timer = PhaseTimer()
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    out = {} if report is None else report
    out["timer"] = timer

    with timer.phase("read"):
        try:
            mesh = read_exodus(cfg.input)
        except (ExodusReadError, FileNotFoundError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    if cfg.refine > 0:
        from ..io import refine_uniform

        with timer.phase("refine"):
            mesh = refine_uniform(mesh, cfg.refine)
        print(f"Refined x{cfg.refine}: {mesh.num_nodes} nodes, "
              f"{mesh.num_elem} elements")
    if cfg.verbose:
        print(
            f"Title: {mesh.title}\n# of Nodes: {mesh.num_nodes}\n"
            f"# of Elements: {mesh.num_elem}\n# of Element Blocks: "
            f"{len(mesh.blocks)}\n# of Node Sets: {len(mesh.node_sets)}\n"
            f"# of Side Sets: {len(mesh.side_sets)}"
        )

    with timer.phase("assemble"):
        system = assemble_heat_system(mesh)
    out["system"] = system
    print(
        f"Assembled {system.n_free} x {system.n_free} Laplacian "
        f"(nnz={system.A.nnz}) from {mesh.num_nodes} nodes"
    )

    if cfg.output_prefix:
        with timer.phase("debug-dumps"):
            print_csr_matrix(system.A, "Laplacian: A", cfg.output_prefix)
            print_vector(system.b, "RHS: B", cfg.output_prefix)

    # Solution file: mesh decomposed into max(2, nparts) partition blocks
    # (the reference hardwires the same, ``BelosMueLuSolver.cpp:210``).
    with timer.phase("decompose"):
        out_mesh = decompose_mesh(mesh, max(2, cfg.partitions))

    # Initial X randomized like the reference (``ExodusIO.hpp:664-666``).
    rng = np.random.default_rng(cfg.seed)
    x0_host = rng.uniform(-1.0, 1.0, size=system.n_free)

    from ..ops.dia import choose_operator
    from ..ops.stencil_kernel import PadStencilOperator
    from ..solvers.cg import CGResult
    from ..solvers.precond.amg import infer_free_grid

    op_dims = (
        infer_free_grid(system.mesh, system.free_to_node)
        if system.mesh is not None
        else None
    )
    with timer.phase("solve"):
        if cfg.partitions > 1:
            with ExodusSolutionWriter(cfg.solution, out_mesh) as writer:
                writer.write_boundary_timestep()

                def snap(total, x_now):
                    writer.write_solution(x_now, system.free_to_node, total)

                result, x_host = _solve_sharded(
                    cfg, system, x0_host, dtype, op_dims, device, timer,
                    out, snapshot_cb=snap if cfg.snapshots else None,
                )
                if not cfg.snapshots:
                    writer.write_solution(x_host, system.free_to_node,
                                          int(result.iterations))
        elif (
            cfg.dtype == "float64"
            and cfg.precond == "amg"
            and cfg.solver == "cg"
            and not cfg.snapshots
            and not cfg.checkpoint
            and np.all(
                system.A.data.astype(np.float32).astype(np.float64)
                == system.A.data
            )
        ):
            # f64 + AMG + CG without snapshots: f32 inner CG+AMG sweeps
            # with the f64 residual on the device reach f64 accuracy
            # (solvers/mixed.py).
            from ..solvers.mixed import iterative_refinement_solve
            from ..solvers.precond.amg import smoothed_aggregation_setup

            with timer.phase("solve.operator"):
                A32 = choose_operator(
                    system.A, dtype=torch.float32, grid_dims=op_dims,
                    pad_stencil="auto", device=device,
                )
            with timer.phase("solve.precond"):
                M32 = smoothed_aggregation_setup(
                    system.A, dtype=torch.float32, grid_dims=op_dims,
                    fine_operator=(
                        A32 if isinstance(A32, PadStencilOperator) else None
                    ),
                    device=device,
                )
            out.update(operator=A32, precond=M32)
            with timer.phase("solve.iterate"):
                mr = iterative_refinement_solve(
                    system.A, system.b, x0=x0_host,
                    tol=cfg.tolerance, inner_maxiter=cfg.iterations,
                    precond=M32, operator=A32,
                )
            out["mixed"] = mr
            result = CGResult(
                x=mr.x, iterations=mr.inner_iterations, relres=mr.relres,
                converged=mr.converged,
            )
            x_host = mr.x
            with ExodusSolutionWriter(cfg.solution, out_mesh) as writer:
                writer.write_boundary_timestep()
                writer.write_solution(
                    x_host, system.free_to_node, int(mr.inner_iterations)
                )
        else:
            result, x_host = _solve_krylov(cfg, system, x0_host, dtype,
                                           op_dims, device, out_mesh, timer,
                                           out)
    out["result"] = result
    if args.debug_nans:
        _check_finite(x_host, result.relres)

    conv = bool(result.converged)
    # Convergence reporting parity (``BelosMueLuSolver.cpp:118-130``).
    print(
        ("Converged" if conv else "DID NOT converge")
        + f" in {int(result.iterations)} iterations "
        f"(achieved tolerance {float(result.relres):.6e})"
    )
    if cfg.output_prefix:
        print_vector(np.asarray(x_host), "Solution: X", cfg.output_prefix)
    if cfg.verbose:
        print(timer.report())
    return 0 if conv else 1


def _solve_krylov(cfg, system, x0_host, dtype, op_dims, device, out_mesh,
                  timer, out):
    """The Krylov routes: cg (resumable with ``--checkpoint``), gmres or
    bicgstab with any preconditioner."""
    from ..io import ExodusSolutionWriter
    from ..ops.dia import choose_operator

    # Preconditioners built from the operator itself (Jacobi, Chebyshev,
    # AMG's fine level) work in its vector space, so the permuted
    # sliced-ELL and padded pad-stencil operators are allowed; the ILU
    # factors are in the original numbering, so they take identity-layout
    # operators (JAX's gate, ``cli/solve.py:195-213`` there).
    own_space = cfg.precond in ("none", "jacobi", "chebyshev", "amg")
    gate = "auto" if own_space else "never"
    with timer.phase("solve.operator"):
        A = choose_operator(system.A, dtype=dtype, bsg=gate,
                            grid_dims=op_dims, pad_stencil=gate,
                            device=device)
    if cfg.verbose:
        print(f"operator format: {type(A).__name__}")
    b = (
        A.put_vector_sparse(system.b, dtype=dtype)
        if hasattr(A, "put_vector_sparse")
        else A.put_vector(system.b, dtype=dtype)
    )
    x0 = A.put_vector(x0_host, dtype=dtype)
    with timer.phase("solve.precond"):
        precond = _make_precond(cfg, A, system, dtype, op_dims, device)
    out.update(operator=A, precond=precond)
    with ExodusSolutionWriter(cfg.solution, out_mesh) as writer:
        writer.write_boundary_timestep()

        def write(x, step):
            writer.write_solution(A.get_vector(x), system.free_to_node, step)

        with timer.phase("solve.iterate"):
            if cfg.solver == "gmres":
                result = _gmres_route(cfg, A, b, x0, precond, write)
            elif cfg.solver == "bicgstab":
                from ..solvers.bicgstab import bicgstab_solve

                result = bicgstab_solve(A, b, x0, precond=precond,
                                        tol=cfg.tolerance,
                                        maxiter=cfg.iterations)
                write(result.x, result.iterations)
            elif cfg.checkpoint:
                from ..solvers.cg import cg_solve_resumable

                result = cg_solve_resumable(
                    A, b, x0, checkpoint_path=cfg.checkpoint,
                    checkpoint_every=cfg.checkpoint_every, precond=precond,
                    tol=cfg.tolerance, maxiter=cfg.iterations,
                )
                write(result.x, result.iterations)
            else:
                from ..solvers.cg import cg_solve_snapshots

                def snapshot(k, x, relres):
                    if cfg.snapshots:
                        write(x, k)
                    if cfg.verbose and k % cfg.report_after_iterations == 0:
                        print(f"iter {k}: relres {relres:.3e}")

                result = cg_solve_snapshots(
                    A, b, x0, precond=precond, tol=cfg.tolerance,
                    maxiter=cfg.iterations, callback=snapshot,
                )
                if not cfg.snapshots:
                    write(result.x, result.iterations)
        x_host = A.get_vector(result.x)
    return result, x_host


def _solve_sharded(cfg, system, x0_host, dtype, op_dims, device, timer, out,
                   snapshot_cb=None):
    """The domain-decomposed route (JAX's ``_solve_sharded``,
    ``cli/solve.py:397-647`` there), every part on ``device``."""
    import torch

    from ..ops.csr import coo_to_csr
    from ..parallel import (
        BSGShardedOperator,
        ShardedOperator,
        build_halo_plan,
        make_device_mesh,
        partition_graph,
        sharded_cg_chunk,
        sharded_cg_solve,
        sharded_gmres_solve,
    )

    nparts = cfg.partitions
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    # Structured meshes with AMG take the slab engines (the global
    # hierarchy over z-slabs); a build that does not fit falls through to
    # the halo route, as in JAX.
    if (cfg.precond == "amg" and cfg.solver != "gmres" and op_dims is not None
            and int(np.prod(op_dims)) == system.A.n_rows):
        routed = _solve_slab(cfg, system, x0_host, dtype, op_dims, device,
                             timer, out)
        if routed is not None:
            result, x_host = routed
            if snapshot_cb is not None:
                snapshot_cb(int(result.iterations), x_host)
            return result, x_host
    A = system.A
    with timer.phase("solve.partition"):
        rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
        off = rows != A.indices
        adj = coo_to_csr(rows[off], A.indices[off],
                         np.ones(int(off.sum())), A.shape, sum_dups=False)
        coords = (system.mesh.coords[system.free_to_node]
                  if system.mesh is not None else None)
        parts = partition_graph(adj, nparts, coords=coords)
    with timer.phase("solve.plan"):
        plan = build_halo_plan(A, parts, nparts, dtype=np_dt)
    out["plan"] = plan
    # f32 with an operator-space preconditioner: the local products run on
    # the sliced-ELL kernel (JAX's rule, with a CUDA device for its TPU).
    op_cls = ShardedOperator
    if (dtype == torch.float32 and device.type == "cuda"
            and cfg.precond in ("none", "jacobi", "chebyshev")):
        op_cls = BSGShardedOperator
    with timer.phase("solve.operator"):
        op = op_cls.from_plan(plan, make_device_mesh(nparts, [device]))
    if cfg.verbose:
        print(f"operator format: {op_cls.__name__} over {nparts} parts "
              f"(n_local {plan.n_local}, halo width {plan.halo_width})")
    b = op.put_vector(system.b)
    x0 = op.put_vector(x0_host)
    # --precond ilu0|ilut runs Jacobi here, as in JAX (its CLI never builds
    # the block ILU); amg + CG takes the global halo hierarchy, then
    # block-Schwarz AMG if that build fails, then Jacobi.
    block_amg = halo_amg = inv_d = None
    with timer.phase("solve.precond"):
        if cfg.precond != "none":
            # Guard degree-0 rows (orphan free nodes).
            deg = np.where(system.degree > 0, system.degree, 1.0)
            inv_d = op.put_vector(1.0 / deg)
            if cfg.precond == "amg" and cfg.solver == "gmres":
                print("warning: distributed AMG is CG-only; "
                      "using Jacobi for the multi-device GMRES solve")
            elif cfg.precond == "amg":
                from ..parallel.haloamg import build_halo_amg

                halo_amg = build_halo_amg(A, plan, dtype=dtype, device=device)
                if halo_amg is None:
                    from ..parallel.schwarz import build_block_amg

                    block_amg = build_block_amg(A, plan, dtype=dtype,
                                                device=device, mesh=op.mesh)
                    if block_amg is None:
                        print("warning: AMG build failed; using Jacobi")
    out.update(operator=op, precond=halo_amg or block_amg)
    with timer.phase("solve.iterate"):
        if halo_amg is not None:
            from ..parallel.haloamg import halo_amg_cg_solve

            if snapshot_cb is not None:
                print("note: per-chunk snapshots are not yet supported with "
                      "the sharded global AMG; writing only the final state")
            x_host, result = halo_amg_cg_solve(
                op, halo_amg, system.b.astype(np_dt), x0_host.astype(np_dt),
                tol=cfg.tolerance, maxiter=cfg.iterations,
            )
            if snapshot_cb is not None:
                snapshot_cb(int(result.iterations), x_host)
            return result, x_host
        if cfg.solver == "gmres":
            result = sharded_gmres_solve(
                op, b, x0, precond_diag=inv_d, restart=cfg.restart,
                tol=cfg.tolerance, maxiter=cfg.iterations,
            )
            if snapshot_cb is not None:
                snapshot_cb(int(result.iterations), op.get_vector(result.x))
            return result, op.get_vector(result.x)
        # For the graph Laplacian, D^-1 A has its spectrum in [0, 2]: an
        # exact Chebyshev bound with no estimate.
        cheb = 2.0 if cfg.precond == "chebyshev" else None
        if snapshot_cb is None or block_amg is not None:
            if snapshot_cb is not None:
                print("note: per-chunk snapshots are not yet supported with "
                      "distributed block-AMG; writing only the final state")
            result = sharded_cg_solve(
                op, b, x0, precond_diag=inv_d, cheb_lmax=cheb,
                block_amg=block_amg, tol=cfg.tolerance,
                maxiter=cfg.iterations,
            )
            if snapshot_cb is not None:
                snapshot_cb(int(result.iterations), op.get_vector(result.x))
            return result, op.get_vector(result.x)
        # Snapshot mode: chunks that thread the exact CG state, one
        # gather and Exodus timestep per chunk (the reference's
        # per-iteration writeSolution, ``BelosMueLuSolver.cpp:112-133``).
        chunk = max(1, cfg.report_after_iterations)
        x_cur, state, total, result = x0, None, 0, None
        while total < cfg.iterations:
            step = min(chunk, cfg.iterations - total)
            result, state = sharded_cg_chunk(
                op, b, x_cur, state, precond_diag=inv_d, cheb_lmax=cheb,
                tol=cfg.tolerance, maxiter=step,
            )
            x_cur = result.x
            total += max(int(result.iterations), 1)
            snapshot_cb(total, op.get_vector(x_cur))
            if result.converged:
                break
        result = dataclasses.replace(result, iterations=total)
        return result, op.get_vector(result.x)


def _solve_slab(cfg, system, x0_host, dtype, op_dims, device, timer, out):
    """The structured ``--partitions N --precond amg`` route, in JAX's
    branch order (``cli/solve.py:411-502`` there): f32 on a CUDA device
    (JAX: on a TPU) the slab-pad AMG, kernel 3 on every slab; f64 with
    f32-exact values the refinement over the slabs; else, or when those
    builds do not fit, the global AMG over slab DIA (or lattice-stencil)
    fine levels.  Returns ``(result, x_host)``, or None when no slab
    hierarchy fits (the caller takes the halo route)."""
    import torch

    from ..parallel.slab import SlabStencilOperator
    from ..parallel.slabamg import build_slab_amg, slab_amg_cg_solve
    from ..parallel.slabpadamg import build_slab_pad_amg, slab_pad_amg_cg_solve
    from ..parallel.slabpadmixed import slab_pad_amg_refine_solve
    from ..solvers.cg import CGResult

    A, nparts = system.A, cfg.partitions
    f32_exact = np.all(A.data.astype(np.float32).astype(np.float64) == A.data)
    pad_route = ((dtype == torch.float32 and device.type == "cuda")
                 or (dtype == torch.float64 and f32_exact))
    if pad_route:
        with timer.phase("solve.precond"):
            spamg = build_slab_pad_amg(A, op_dims, nparts, device=device)
        if spamg is not None:
            out.update(operator=spamg.A, precond=spamg,
                       plan=spamg.plan)
            if cfg.verbose:
                print(f"slab-pad AMG over {nparts} slabs of {spamg.plan.L} "
                      f"layers (kernel 3 per slab)")
            with timer.phase("solve.iterate"):
                if dtype == torch.float32:
                    x_host, result = slab_pad_amg_cg_solve(
                        spamg, system.b.astype(np.float32),
                        x0_host.astype(np.float32), tol=cfg.tolerance,
                        maxiter=cfg.iterations)
                    return result, x_host
                mr = slab_pad_amg_refine_solve(
                    spamg, b=system.b.astype(np.float64),
                    x0=x0_host.astype(np.float64), tol=cfg.tolerance,
                    inner_maxiter=cfg.iterations)
            out["mixed"] = mr
            return CGResult(x=mr.x, iterations=mr.inner_iterations,
                            relres=mr.relres, converged=mr.converged), mr.x
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    with timer.phase("solve.precond"):
        samg = build_slab_amg(A, op_dims, nparts, dtype=np_dt, device=device)
    if samg is None:
        return None
    out.update(precond=samg, plan=samg.plan)
    if cfg.verbose:
        fine = ("lattice stencil" if isinstance(samg.A, SlabStencilOperator)
                else "DIA")
        print(f"slab AMG over {nparts} slabs ({fine} fine level)")
    with timer.phase("solve.iterate"):
        x_host, result = slab_amg_cg_solve(
            samg, system.b.astype(np_dt), x0_host.astype(np_dt),
            tol=cfg.tolerance, maxiter=cfg.iterations)
    return result, x_host


def _gmres_route(cfg, A, b, x0, precond, write):
    """GMRES(restart).  With snapshots: one per restart cycle, warm-started
    (the reference's convergence animation, ``BelosMueLuSolver.cpp:
    112-133``, without its per-iteration reset); with
    ``--snapshot-every-iteration`` the reset itself, one Arnoldi step per
    solve call, then write X and restart from it."""
    import dataclasses

    from ..solvers.gmres import gmres_solve

    if not cfg.snapshots:
        result = gmres_solve(A, b, x0, precond=precond, restart=cfg.restart,
                             tol=cfg.tolerance, maxiter=cfg.iterations)
        write(result.x, result.iterations)
        return result
    per_iter = cfg.snapshot_every_iteration
    x_cur, total, result = x0, 0, None
    while total < cfg.iterations:
        step = 1 if per_iter else min(cfg.restart, cfg.iterations - total)
        result = gmres_solve(A, b, x_cur, precond=precond,
                             restart=1 if per_iter else cfg.restart,
                             tol=cfg.tolerance, maxiter=step)
        x_cur = result.x
        total += max(result.iterations, 1)
        write(x_cur, total)
        if cfg.verbose:
            print(f"iter {total}: relres {result.relres:.3e}")
        if result.converged:
            break
    return dataclasses.replace(result, iterations=total)


def _make_precond(cfg, A, system, dtype, op_dims, device):
    from ..ops.bsg import BSGMatrix
    from ..ops.stencil_kernel import PadStencilOperator
    from ..solvers.precond import (
        chebyshev_preconditioner,
        estimate_lmax_dinv_a,
        ilu0_preconditioner,
        ilut_preconditioner,
        jacobi_preconditioner,
        smoothed_aggregation_setup,
    )

    if cfg.precond == "none":
        return None
    if cfg.precond == "jacobi":
        return jacobi_preconditioner(A)
    if cfg.precond == "chebyshev":
        lmax = estimate_lmax_dinv_a(A, dtype=dtype)
        return chebyshev_preconditioner(A, lmax, dtype=dtype)
    if cfg.precond == "ilu0":
        # Host factorization, level-scheduled sweeps on the device.
        return ilu0_preconditioner(system.A, n_pad=A.n_pad, dtype=dtype,
                                   device=device)
    if cfg.precond == "ilut":
        # Ifpack2 ILUT at its defaults (level-of-fill 1.0, drop tolerance
        # 0, ``BelosMueLuSolver.cpp:92-97``).
        return ilut_preconditioner(system.A, n_pad=A.n_pad, dtype=dtype,
                                   device=device)
    # amg: structured meshes get brick transfers; operators that own their
    # vector space (sliced ELL, pad-stencil) are the fine level.
    return smoothed_aggregation_setup(
        system.A,
        dtype=dtype,
        grid_dims=op_dims,
        fine_operator=(
            A if isinstance(A, (BSGMatrix, PadStencilOperator)) else None
        ),
        device=device,
    )


if __name__ == "__main__":
    sys.exit(main())
