"""Solver/driver configuration — the Teuchos CLI + ParameterList analogue.

A copy of the JAX package's ``utils/config.py`` (same fields, defaults
and flags).

The reference configures each driver with ``Teuchos::CommandLineProcessor``
flags (``BelosMueLuSolver.cpp:144-159``) and solver parameters through
``Teuchos::ParameterList`` (``:91, :101-103``).  Here a plain dataclass holds
the same knobs with the same defaults, fed either programmatically or from
``argparse`` in the CLI drivers.
"""

from __future__ import annotations

import argparse
import dataclasses

__all__ = ["SolveConfig", "add_solve_args", "config_from_args"]


@dataclasses.dataclass
class SolveConfig:
    """Defaults mirror the reference driver (``BelosMueLuSolver.cpp:144-159``)."""

    input: str = ""
    solution: str = "solution.exo"  # --solution output Exodus file
    iterations: int = 300  # max outer iterations (:149)
    tolerance: float = 1e-14  # convergence tolerance (:151)
    verbose: bool = False
    output_prefix: str = ""  # per-shard debug dump prefix (:172-174)
    report_after_iterations: int = 10  # parsed in reference but unused (:155)
    # Framework extensions:
    solver: str = "cg"  # cg | gmres
    precond: str = "jacobi"  # none | jacobi | chebyshev | amg
    partitions: int = 1  # device-mesh width (mpirun -n analogue)
    dtype: str = "float64"  # float32 | float64
    snapshots: bool = True  # write per-iteration timesteps like the reference
    # Literal-parity GMRES animation mode: restart after EVERY outer
    # iteration, exactly the reference's solve/writeSolution/reset loop
    # (``BelosMueLuSolver.cpp:112-133``), Krylov-space reset included.
    # Default off: warm per-restart-cycle snapshots converge far faster.
    snapshot_every_iteration: bool = False
    restart: int = 30  # GMRES restart length
    seed: int = 0  # X randomization seed (reference uses time(NULL), :665)
    refine: int = 0  # uniform refinement levels before assembly
    checkpoint: str = ""  # checkpoint file for resumable CG
    checkpoint_every: int = 50


def add_solve_args(ap: argparse.ArgumentParser) -> None:
    d = SolveConfig()
    ap.add_argument("--input", required=True, help="input Exodus-II mesh")
    ap.add_argument("--solution", default=d.solution, help="output Exodus file")
    ap.add_argument("--iterations", type=int, default=d.iterations)
    ap.add_argument("--tolerance", type=float, default=d.tolerance)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--outputPrefix", dest="output_prefix", default=d.output_prefix)
    ap.add_argument(
        "--reportAfterIterations",
        dest="report_after_iterations",
        type=int,
        default=d.report_after_iterations,
    )
    ap.add_argument("--solver", choices=["cg", "gmres", "bicgstab"], default=d.solver)
    ap.add_argument(
        "--precond", choices=["none", "jacobi", "chebyshev", "amg", "ilu0", "ilut"], default=d.precond
    )
    ap.add_argument("--partitions", type=int, default=d.partitions)
    ap.add_argument("--dtype", choices=["float32", "float64"], default=d.dtype)
    ap.add_argument("--no-snapshots", dest="snapshots", action="store_false")
    ap.add_argument(
        "--snapshot-every-iteration",
        dest="snapshot_every_iteration",
        action="store_true",
        help="GMRES: restart + snapshot after every outer iteration "
        "(literal BelosMueLuSolver.cpp:112-133 animation parity)",
    )
    ap.add_argument("--restart", type=int, default=d.restart)
    ap.add_argument("--seed", type=int, default=d.seed)
    ap.add_argument("--refine", type=int, default=d.refine,
                    help="uniform refinement levels before assembly")
    ap.add_argument("--checkpoint", default=d.checkpoint,
                    help="CG checkpoint file (enables exact resume)")
    ap.add_argument("--checkpoint-every", dest="checkpoint_every", type=int,
                    default=d.checkpoint_every)


def config_from_args(args: argparse.Namespace) -> SolveConfig:
    fields = {f.name for f in dataclasses.fields(SolveConfig)}
    return SolveConfig(**{k: v for k, v in vars(args).items() if k in fields})
