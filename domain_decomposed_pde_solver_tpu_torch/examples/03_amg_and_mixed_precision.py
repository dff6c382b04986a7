"""AMG preconditioning and mixed-precision refinement.

Shows the two levers that make large solves fast on the card:
  - SA-AMG: h-independent iteration counts (~10 regardless of mesh size);
  - iterative refinement: f64-accurate answers from an f32 device solver.

Run:  python domain_decomposed_pde_solver_tpu_torch/examples/03_amg_and_mixed_precision.py [--cpu]
"""

import argparse

import torch

from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
from domain_decomposed_pde_solver_tpu_torch.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu_torch.ops import (
    choose_operator,
    pad_vector,
)
from domain_decomposed_pde_solver_tpu_torch.solvers import (
    cg_solve,
    iterative_refinement_solve,
    jacobi_preconditioner,
    smoothed_aggregation_setup,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="compute on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None  # None: the card

    system = assemble_heat_system(box_mesh(24, 24, 24, elem_type="TETRA4"))
    A = choose_operator(system.A, dtype=torch.float64, device=device)
    b = pad_vector(system.b, A.n_pad, device=A.device)

    # Jacobi vs AMG iteration counts.
    r_j = cg_solve(A, b, torch.zeros_like(b), precond=jacobi_preconditioner(A),
                   tol=1e-10, maxiter=3000)
    M = smoothed_aggregation_setup(system.A, dtype=torch.float64,
                                   device=device)
    r_a = cg_solve(A, b, torch.zeros_like(b), precond=M, tol=1e-10,
                   maxiter=300)
    print(f"CG+Jacobi: {int(r_j.iterations)} iterations")
    print(f"CG+AMG:    {int(r_a.iterations)} iterations "
          f"({len(M.levels) + 1} levels)")

    # Mixed precision: the device works in f32, answers come out
    # f64-accurate.
    res = iterative_refinement_solve(system.A, system.b, tol=1e-10,
                                     device=device)
    print(f"f32 device + refinement: relres {res.relres:.2e} "
          f"in {res.refinements} sweeps / {res.inner_iterations} inner "
          f"iterations")


if __name__ == "__main__":
    main()
