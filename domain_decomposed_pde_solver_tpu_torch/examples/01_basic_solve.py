"""Basic end-to-end solve: mesh -> assembly -> CG -> Exodus output.

The library-level equivalent of
``mpirun exec/BelosMueLuSolver --input mesh.exo --solution out.exo``, on
the PyTorch/CUDA port (the card by default; ``--cpu`` for the CPU).

Run:  python domain_decomposed_pde_solver_tpu_torch/examples/01_basic_solve.py [--cpu] [mesh.exo]
"""

import argparse
import os
import tempfile

import torch

from domain_decomposed_pde_solver_tpu_torch.io import (
    ExodusSolutionWriter,
    box_mesh,
    read_exodus,
)
from domain_decomposed_pde_solver_tpu_torch.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu_torch.ops import (
    choose_operator,
    pad_vector,
    unpad_vector,
)
from domain_decomposed_pde_solver_tpu_torch.solvers import (
    cg_solve,
    jacobi_preconditioner,
)

# The system temporary directory (``/tmp`` unless TMPDIR says otherwise).
OUT = os.path.join(tempfile.gettempdir(), "example_solution_torch.exo")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mesh", nargs="?", help="an Exodus mesh (default: a box)")
    ap.add_argument("--cpu", action="store_true", help="compute on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None  # None: the card

    # 1. Mesh: an Exodus file, or a generated box.
    mesh = (read_exodus(args.mesh) if args.mesh
            else box_mesh(20, 20, 20, elem_type="TETRA4"))
    print(f"mesh: {mesh.num_nodes} nodes, {mesh.num_elem} elements")

    # 2. Assemble the reduced Laplacian (nodeset-based Dirichlet elimination).
    system = assemble_heat_system(mesh)
    print(f"system: {system.n_free} DOF, nnz={system.A.nnz}")

    # 3. Device operator: DIA for structured meshes, ELL otherwise.
    A = choose_operator(system.A, dtype=torch.float64, device=device)
    print(f"format: {type(A).__name__}")

    # 4. Solve with preconditioned CG.
    b = pad_vector(system.b, A.n_pad, device=A.device)
    res = cg_solve(A, b, torch.zeros_like(b), precond=jacobi_preconditioner(A),
                   tol=1e-12, maxiter=1000)
    x = unpad_vector(res.x, system.n_free)
    print(f"converged={bool(res.converged)} in {int(res.iterations)} "
          f"iterations")

    # 5. Write the solution (timestep 0 = boundary snapshot, like the
    #    reference).
    with ExodusSolutionWriter(OUT, mesh) as w:
        w.write_solution(x, system.free_to_node, int(res.iterations))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
