"""Partitioned GLOBAL SA-AMG: P-independent iteration counts.

Block-Schwarz preconditioners (example 02's strategies) trade iteration
count for zero communication; the partitioned *global* hierarchy
(``parallel/slabamg.py``) keeps the single-device count exactly: the fine
level is split into z-slabs (neighbour-strip halos), the brick grid
transfers stay local to each slab, and the tiny coarse levels are
replicated on every part.  The port drives every part from one
controller on one device (the card by default, ``--cpu`` for the CPU),
so every P runs; under a launcher of several processes each holds its
own parts on its own card and process 0 prints
(``parallel.multihost.launched``), over every P they divide.

Run:  python domain_decomposed_pde_solver_tpu_torch/examples/06_distributed_amg.py [--cpu]
      torchrun --nproc-per-node 2 \\
          domain_decomposed_pde_solver_tpu_torch/examples/06_distributed_amg.py
"""

import argparse

import numpy as np
import torch

from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
from domain_decomposed_pde_solver_tpu_torch.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu_torch.ops import choose_operator
from domain_decomposed_pde_solver_tpu_torch.parallel import (
    build_slab_amg,
    make_device_mesh,
    slab_amg_cg_solve,
)
from domain_decomposed_pde_solver_tpu_torch.parallel.multihost import (
    launch_refusal,
    launched,
)
from domain_decomposed_pde_solver_tpu_torch.solvers import cg_solve
from domain_decomposed_pde_solver_tpu_torch.solvers.precond.amg import (
    infer_free_grid,
    smoothed_aggregation_setup,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="compute on the CPU")
    args = ap.parse_args(argv)
    with launched(cpu=args.cpu) as device:
        run(device)


def run(device):
    mesh = box_mesh(30, 30, 48, elem_type="TETRA4")
    system = assemble_heat_system(mesh)
    dims = infer_free_grid(mesh, system.free_to_node)
    print(f"{system.n_free} free DOF, free grid {dims}")

    b = (system.b / np.abs(system.b).max()).astype(np.float32)

    # Single-device reference hierarchy.
    M1 = smoothed_aggregation_setup(system.A, dtype=torch.float32,
                                    grid_dims=dims, device=device)
    A1 = choose_operator(system.A, dtype=torch.float32, grid_dims=dims,
                         device=device)
    bj = A1.put_vector(b)
    r1 = cg_solve(A1, bj, torch.zeros_like(bj), precond=M1, tol=1e-6,
                  maxiter=100)
    print(f"single device : {int(r1.iterations)} iterations")

    # The SAME hierarchy over P parts.
    for P in (2, 4, 8):
        refusal = launch_refusal(P)
        if refusal:
            print(f"P={P}: not run, {refusal}")
            continue
        samg = build_slab_amg(system.A, dims, P, device=device,
                              mesh=make_device_mesh(P, [device]))
        if samg is None:
            print(f"P={P}: slab layout unavailable for these dims")
            continue
        _x, res = slab_amg_cg_solve(samg, b, np.zeros_like(b), tol=1e-6,
                                    maxiter=100)
        print(f"P={P} sharded  : {int(res.iterations)} iterations "
              f"(relres {float(res.relres):.1e})")


if __name__ == "__main__":
    main()
