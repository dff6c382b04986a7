"""Partitioned f64-accurate solve: slab CG+AMG inside f64 refinement.

The slab-pad engine (the pad-stencil kernel on every slab's window, the
global SA-AMG hierarchy over the slabs) runs the f32 inner sweeps; an f64
refinement loop on the device with a neighbour-strip f64 slab product
drives the true residual below anything a pure-f32 solve can reach -- the
1e-8+ BASELINE accuracy metric, over P parts.  The reference has no
distributed mixed-precision capability (``BelosMueLuSolver.cpp:87-139``
is f64 GMRES+ILUT throughout).  The port drives every part from one
controller on one device (the card by default, ``--cpu`` for the CPU);
under a launcher of several processes each holds its own parts on its
own card and process 0 prints (``parallel.multihost.launched``), over
every P they divide.

Run:  python domain_decomposed_pde_solver_tpu_torch/examples/07_sharded_f64_refinement.py [--cpu]
      torchrun --nproc-per-node 2 \\
          domain_decomposed_pde_solver_tpu_torch/examples/07_sharded_f64_refinement.py
"""

import argparse

import numpy as np
import scipy.sparse as sp

from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
from domain_decomposed_pde_solver_tpu_torch.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu_torch.parallel import (
    build_slab_pad_amg,
    make_device_mesh,
    slab_pad_amg_refine_solve,
)
from domain_decomposed_pde_solver_tpu_torch.parallel.multihost import (
    launch_refusal,
    launched,
)
from domain_decomposed_pde_solver_tpu_torch.solvers.precond.amg import (
    infer_free_grid,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="compute on the CPU")
    args = ap.parse_args(argv)
    with launched(cpu=args.cpu) as device:
        run(device)


def run(device):
    mesh = box_mesh(26, 26, 46, elem_type="TETRA4")
    system = assemble_heat_system(mesh)
    dims = infer_free_grid(mesh, system.free_to_node)
    print(f"{system.n_free} free DOF, free grid {dims}")
    S = sp.csr_matrix(
        (system.A.data, system.A.indices, system.A.indptr),
        shape=system.A.shape,
    )

    for P in (2, 4):
        refusal = launch_refusal(P)
        if refusal:
            print(f"P={P}: not run, {refusal}")
            continue
        samg = build_slab_pad_amg(system.A, dims, P, device=device,
                                  mesh=make_device_mesh(P, [device]))
        if samg is None:
            print(f"P={P}: slab layout unavailable for these dims")
            continue
        res = slab_pad_amg_refine_solve(samg, b=system.b, tol=1e-10)
        true_rr = np.linalg.norm(S @ res.x - system.b) / np.linalg.norm(
            system.b)
        print(f"P={P}: {res.refinements} sweeps / {res.inner_iterations} "
              f"inner f32 iterations -> true f64 residual {true_rr:.1e}")
        if not true_rr < 1e-9:
            raise SystemExit(f"P={P}: true f64 residual {true_rr:.1e} "
                             f">= 1e-9")


if __name__ == "__main__":
    main()
