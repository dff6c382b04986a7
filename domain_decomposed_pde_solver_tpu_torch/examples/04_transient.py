"""Transient heat flow with per-step Exodus animation output.

The physical version of the reference's convergence animation: implicit
Euler time stepping with one Exodus timestep per physical step.

Run:  python domain_decomposed_pde_solver_tpu_torch/examples/04_transient.py [--cpu]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from domain_decomposed_pde_solver_tpu_torch.io import (
    ExodusSolutionWriter,
    box_mesh,
)
from domain_decomposed_pde_solver_tpu_torch.models import (
    assemble_heat_system,
    transient_heat_solve,
)
from domain_decomposed_pde_solver_tpu_torch.ops import choose_operator
from domain_decomposed_pde_solver_tpu_torch.solvers import lanczos_extremes

# The system temporary directory (``/tmp`` unless TMPDIR says otherwise).
OUT = os.path.join(tempfile.gettempdir(), "example_transient_torch.exo")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="compute on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None  # None: the card

    mesh = box_mesh(12, 12, 12, elem_type="TETRA4")
    system = assemble_heat_system(mesh)
    A = choose_operator(system.A, dtype=torch.float64, device=device)

    # Spectrum edges -> decay time scale of the flow.
    z0 = np.zeros(A.n_pad)
    z0[: system.n_free] = np.random.default_rng(0).standard_normal(
        system.n_free)
    spec = lanczos_extremes(A, torch.as_tensor(z0, device=A.device), k=40)
    print(f"spectrum: [{float(spec.lmin):.3f}, {float(spec.lmax):.3f}] "
          f"(condition {float(spec.condition):.0f}); slowest decay "
          f"~{1.0 / float(spec.lmin):.1f} time units")

    with ExodusSolutionWriter(OUT, mesh) as writer:
        writer.write_boundary_timestep()
        res = transient_heat_solve(
            system, A, dt=0.2, n_steps=40, tol=1e-10,
            # Physical time as the Exodus time value (writer floats it).
            callback=lambda k, t, u: writer.write_solution(
                u, system.free_to_node, t),
        )
    print(f"integrated 40 steps with {res.total_cg_iterations} total CG "
          f"iterations (warm starts); wrote {OUT}")


if __name__ == "__main__":
    main()
