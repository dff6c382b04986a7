"""Power-method driver — the ``ExodusMatrixTest`` executable.

Counterpart of the JAX package's ``cli/matrix_test.py``: build the
full-mesh Laplacian (``IO::getMatrix``) and run 500 power
iterations at tolerance 1e-2, reporting every 50
(``ExodusMatrixTest.cpp:131-171``), with JAX's start vector
(``default_rng(seed).uniform``), report lines and final line.  The operator
is the padded ELL in float64 (a plain PyTorch product, as JAX's ELL is an
XLA one).  With ``--partitions >= 2`` (the reference's >= 2 ranks,
``ExodusMatrixTest.cpp:146-149``) the Laplacian is partitioned over a halo
plan and the power method runs over the parts
(``parallel.sharded_power_method``) in one call, printing the final line
only, as JAX's does: one process holds every part on its one device;
under a launcher of K processes each holds ``--partitions`` / K of them on
its own card, as ``cli/solve.py`` does (every process partitions the
whole mesh, the partitions are checked to agree, process 0 alone prints,
a count K does not divide is refused).  It runs on the card; ``--cpu``
runs it on the CPU.

Usage::

    python -m domain_decomposed_pde_solver_tpu_torch.cli.matrix_test \\
        --input mesh.exo
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional


def main(argv=None, report: Optional[dict] = None) -> int:
    """Run the driver; returns the exit code.  ``report``: an optional dict
    that receives the run's ``laplacian`` (host CSR), ``operator``,
    ``result`` (the last :class:`PowerResult`) and, with ``--partitions``,
    ``plan``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--iterations", type=int, default=500)
    ap.add_argument("--tolerance", type=float, default=1e-2)
    ap.add_argument("--reportFrequency", type=int, default=50)
    ap.add_argument("--partitions", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..parallel.collectives import from_root
    from ..parallel.multihost import launch_refusal, launched

    refusal = launch_refusal(args.partitions)
    if refusal:
        print(f"error: --partitions {refusal}", file=sys.stderr)
        return 2
    with launched(cpu=args.cpu) as device:
        return from_root(_run(args, device, report))


def _run(args, device, report) -> int:
    """The driver on ``device``, in this process of the launcher's group
    (or alone)."""
    import numpy as np
    import torch

    from ..io import ExodusReadError, read_exodus
    from ..models.laplacian import assemble_full_laplacian
    from ..ops.ell import ell_from_csr
    from ..parallel.collectives import max_scalar
    from ..solvers.power import power_method

    try:
        mesh = read_exodus(args.input)
    except (ExodusReadError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        mesh = None
    if max_scalar(mesh is None):  # every process stops if one cannot read
        return 1
    L = assemble_full_laplacian(mesh)
    rng = np.random.default_rng(args.seed)
    z0_host = rng.uniform(size=L.n_rows)

    out = {} if report is None else report
    if args.partitions > 1:
        res = _sharded_power(args, mesh, L, z0_host, device, out)
        out["result"] = res
        print(f"lambda_max ~= {res.eigenvalue:.10g} after {res.iterations} "
              f"iterations (residual {res.residual:.3e}, "
              f"converged={res.converged})")
        return 0
    A = ell_from_csr(L, dtype=torch.float64, device=device)
    out.update(laplacian=L, operator=A)
    z = A.put_vector(z0_host)
    # Chunked so that the estimate prints every reportFrequency
    # iterations, as the reference's does (``ExodusMatrixTest.cpp:95-107``).
    done = 0
    res = power_method(A, z, maxiter=0, tol=args.tolerance, check_every=1)
    while done < args.iterations:
        step = min(args.reportFrequency, args.iterations - done)
        res = power_method(A, z, maxiter=step, tol=args.tolerance,
                           check_every=step)
        z = res.eigenvector
        done += max(res.iterations, 1)
        print(f"  iteration {done}: lambda ~= {res.eigenvalue:.10g} "
              f"residual {res.residual:.3e}")
        if res.converged:
            break
    out["result"] = res
    print(f"lambda_max ~= {res.eigenvalue:.10g} after {done} iterations "
          f"(residual {res.residual:.3e}, converged={res.converged})")
    return 0


def _sharded_power(args, mesh, L, z0_host, device, out):
    """The power method over a ``--partitions``-way halo plan of ``L``."""
    import numpy as np

    from ..ops.csr import coo_to_csr
    from ..parallel.collectives import agree
    from ..parallel import (
        ShardedOperator,
        build_halo_plan,
        make_device_mesh,
        partition_graph,
        sharded_power_method,
    )

    rows = np.repeat(np.arange(L.n_rows), L.row_lengths())
    off = rows != L.indices
    adj = coo_to_csr(rows[off], L.indices[off], np.ones(int(off.sum())),
                     L.shape, sum_dups=False)
    parts = partition_graph(adj, args.partitions, coords=mesh.coords)
    plan = build_halo_plan(L, parts, args.partitions)
    agree("the partition", parts, [plan.nparts, plan.n_local, plan.halo_width])
    op = ShardedOperator.from_plan(
        plan, make_device_mesh(args.partitions, [device]))
    out.update(laplacian=L, operator=op, plan=plan)
    return sharded_power_method(
        op, op.put_vector(z0_host), maxiter=args.iterations,
        tol=args.tolerance, check_every=args.reportFrequency,
    )


if __name__ == "__main__":
    sys.exit(main())
