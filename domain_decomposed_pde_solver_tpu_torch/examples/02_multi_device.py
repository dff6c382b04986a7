"""Domain-decomposed solve over a mesh of parts.

Two partitioning strategies:
  (a) general graph partition + halo exchange (any mesh);
  (b) contiguous slabs + neighbour strips (banded/structured).

JAX runs one part per device under ``shard_map``; the port drives all P
parts from one controller on one device (the card by default, ``--cpu``
for the CPU), so every P runs without more devices.  Under a launcher of
several processes each holds its own parts on its own card and process 0
prints (``parallel.multihost.launched``).

Run:  python domain_decomposed_pde_solver_tpu_torch/examples/02_multi_device.py [--cpu]
      torchrun --nproc-per-node 2 \\
          domain_decomposed_pde_solver_tpu_torch/examples/02_multi_device.py
"""

import argparse

import numpy as np
import torch

from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
from domain_decomposed_pde_solver_tpu_torch.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu_torch.ops import coo_to_csr
from domain_decomposed_pde_solver_tpu_torch.parallel import (
    ShardedOperator,
    build_halo_plan,
    build_slab_plan,
    make_device_mesh,
    partition_graph,
    sharded_cg_solve,
    slab_cg_solve,
)
from domain_decomposed_pde_solver_tpu_torch.parallel.multihost import launched

P = 8


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="compute on the CPU")
    args = ap.parse_args(argv)
    with launched(cpu=args.cpu) as device:
        run(make_device_mesh(P, [device]))


def run(dmesh):
    mesh = box_mesh(16, 16, 16, elem_type="TETRA4")
    system = assemble_heat_system(mesh)
    print(f"{system.n_free} DOF over {P} parts")

    # (a) General path: graph partition + halo plan + partitioned CG.
    A = system.A
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    off = rows != A.indices
    adj = coo_to_csr(rows[off], A.indices[off], np.ones(int(off.sum())),
                     A.shape, sum_dups=False)
    parts = partition_graph(adj, P, coords=mesh.coords[system.free_to_node])
    plan = build_halo_plan(A, parts, P)
    op = ShardedOperator.from_plan(plan, dmesh)
    b = op.put_vector(system.b)
    res = sharded_cg_solve(
        op, b, torch.zeros_like(b),
        precond_diag=op.put_vector(1.0 / system.degree),
        cheb_lmax=2.0,  # exact bound for normalized graph Laplacians
        tol=1e-11, maxiter=2000,
    )
    print(f"(a) halo-exchange CG: {int(res.iterations)} iterations, "
          f"relres {float(res.relres):.2e}")

    # (b) Slab path (structured/banded operators).
    splan = build_slab_plan(A, P, dtype=np.float64)
    if splan is not None:
        _x2, res2 = slab_cg_solve(splan, system.b, np.zeros(A.n_rows),
                                  tol=1e-11, maxiter=2000, mesh=dmesh)
        print(f"(b) slab-DIA CG: {int(res2.iterations)} iterations, "
              f"halo width {splan.halo} per neighbor")


if __name__ == "__main__":
    main()
