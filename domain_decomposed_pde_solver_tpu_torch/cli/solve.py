"""Heat-equation solve driver — the ``BelosMueLuSolver`` executable.

Counterpart of the JAX package's ``cli/solve.py``, single-device routes:
open -> assemble -> dump A and B (``--outputPrefix``) -> decompose the mesh
into ``max(2, nparts)`` partition blocks for the solution file -> solve ->
dump X.  Two solve routes, chosen as JAX chooses them:

- ``--dtype float64 --precond amg --no-snapshots`` (CG, f32-exact
  operator): mixed-precision iterative refinement — f32 CG+AMG sweeps with
  the f64 residual on the device; on a structured box the operator is the
  pad-stencil one and AMG takes it as its fine level;
- otherwise CG with per-iteration snapshots and none/jacobi/amg.

The solve runs on the card; ``--cpu`` runs it on the CPU.  Routes not
ported raise ``NotImplementedError`` naming their ``ROADMAP.md`` item.

Usage::

    python -m domain_decomposed_pde_solver_tpu_torch.cli.solve \\
        --input mesh.exo --solution solution.exo --tolerance 1e-8 \\
        --dtype float64 --precond amg --no-snapshots
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np

_NOT_PORTED = {
    "partitions": "multi-device solves (ROADMAP.md, Queue 1, item 9)",
    "gmres": "GMRES (ROADMAP.md, Queue 1, item 8)",
    "bicgstab": "BiCGSTAB (ROADMAP.md, Queue 1, item 8)",
    "ilu0": "ILU(0) (ROADMAP.md, Queue 1, item 8)",
    "ilut": "ILUT (ROADMAP.md, Queue 1, item 8)",
    "chebyshev": "the Chebyshev preconditioner (ROADMAP.md, Queue 1, item 8)",
    "checkpoint": "resumable CG checkpoints (ROADMAP.md, Queue 1, item 8)",
}


def _check_ported(cfg) -> None:
    if cfg.partitions > 1:
        raise NotImplementedError(f"--partitions {cfg.partitions}: "
                                  f"{_NOT_PORTED['partitions']}")
    if cfg.solver != "cg":
        raise NotImplementedError(f"--solver {cfg.solver}: "
                                  f"{_NOT_PORTED[cfg.solver]}")
    if cfg.precond in ("ilu0", "ilut", "chebyshev"):
        raise NotImplementedError(f"--precond {cfg.precond}: "
                                  f"{_NOT_PORTED[cfg.precond]}")
    if cfg.checkpoint:
        raise NotImplementedError(f"--checkpoint: {_NOT_PORTED['checkpoint']}")


def main(argv=None, report: Optional[dict] = None) -> int:
    """Run the driver; returns the exit code (0 when converged).

    ``report``: an optional dict that receives the run's objects —
    ``timer``, ``system``, ``operator``, ``precond``, ``result`` and, on
    the mixed route, ``mixed`` (the :class:`MixedSolveResult`) — for
    callers that drive the CLI in process."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    from ..utils.config import add_solve_args, config_from_args

    add_solve_args(ap)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = config_from_args(args)
    _check_ported(cfg)

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
        if (
            cfg.dtype == "float64"
            and cfg.precond == "amg"
            and not cfg.snapshots
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
            result, x_host = _solve_cg(cfg, system, x0_host, dtype, op_dims,
                                       device, out_mesh, timer, out)
    out["result"] = result

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


def _solve_cg(cfg, system, x0_host, dtype, op_dims, device, out_mesh, timer,
              out):
    """The CG route: per-iteration snapshots, none/jacobi/amg."""
    from ..io import ExodusSolutionWriter
    from ..ops.dia import choose_operator
    from ..solvers.cg import cg_solve_snapshots

    with timer.phase("solve.operator"):
        A = choose_operator(
            system.A, dtype=dtype, bsg="auto", grid_dims=op_dims,
            # The padded-3-D stencil owns its vector space, as the
            # sliced-ELL operator does, so it shares the gate.
            pad_stencil="auto", device=device,
        )
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

        def snapshot(k, x, relres):
            if cfg.snapshots:
                writer.write_solution(A.get_vector(x), system.free_to_node, k)
            if cfg.verbose and k % cfg.report_after_iterations == 0:
                print(f"iter {k}: relres {relres:.3e}")

        with timer.phase("solve.iterate"):
            result = cg_solve_snapshots(
                A, b, x0, precond=precond, tol=cfg.tolerance,
                maxiter=cfg.iterations, callback=snapshot,
            )
        x_host = A.get_vector(result.x)
        if not cfg.snapshots:
            writer.write_solution(x_host, system.free_to_node,
                                  int(result.iterations))
    return result, x_host


def _make_precond(cfg, A, system, dtype, op_dims, device):
    from ..ops.bsg import BSGMatrix
    from ..ops.stencil_kernel import PadStencilOperator
    from ..solvers.precond.amg import smoothed_aggregation_setup
    from ..solvers.precond.jacobi import jacobi_preconditioner

    if cfg.precond == "none":
        return None
    if cfg.precond == "jacobi":
        return jacobi_preconditioner(A)
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
