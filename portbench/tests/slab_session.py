"""A deployment for the harness's own tests of a cell on several cards,
copied into a test checkout's ``portbench/systems/``: the port's slab CG
across processes (``parallel/multihost.py::multihost_slab_cg_solve``), f64
Jacobi-CG over z-slabs of a generated box, one slab per rank on the rank's
own device, every rank getting the whole host answer.

The client forms the right-hand side as ``structured_box.py`` does: each
face's temperature times its coupling, read once from the right-hand side
the program assembles for the nodesets' own ids.  Each request solves warm
from the previous answer.
"""

from __future__ import annotations

import numpy as np

from . import Answer


class Session:
    def __init__(self, config, traffic, device, spans):
        from domain_decomposed_pde_solver_tpu_torch.models.structured import (
            structured_box_system,
        )
        from domain_decomposed_pde_solver_tpu_torch.parallel import (
            make_device_mesh,
        )
        from domain_decomposed_pde_solver_tpu_torch.parallel.collectives import (
            process_world,
        )
        from domain_decomposed_pde_solver_tpu_torch.parallel.slab import (
            build_slab_plan,
        )

        n = int(config["mesh"]["cells"][0])
        ids = [int(i) for i in config["mesh"]["nodesets"]]
        with spans.span("assembly"):
            sy = structured_box_system(n, n, n, "TETRA4", bc_ids=tuple(ids))
        world = process_world()
        self.mesh = make_device_mesh(world, [device])
        self.plan = build_slab_plan(sy.A, nparts=world, dtype=np.float64)
        b = np.asarray(sy.b, dtype=np.float64)
        col = np.arange(b.size) % (n - 1)
        self.rows = {ids[0]: np.flatnonzero(col == 0),
                     ids[1]: np.flatnonzero(col == n - 2)}
        self.coupling = {i: b[r] / i for i, r in self.rows.items()}
        self.b = np.zeros_like(b)
        self.x = np.zeros_like(b)
        self.traffic = traffic

    def prepare(self, temps) -> None:
        for i, r in self.rows.items():
            self.b[r] = float(temps[i]) * self.coupling[i]

    def request(self, temps) -> Answer:
        from domain_decomposed_pde_solver_tpu_torch.parallel import (
            multihost_slab_cg_solve,
        )

        x, res = multihost_slab_cg_solve(
            self.plan, self.b, self.x, tol=self.traffic["tol"],
            maxiter=self.traffic["maxiter"], mesh=self.mesh)
        self.x = x
        return Answer(x=x, iterations=int(res.iterations),
                      converged=bool(res.converged))

    def fine_operators(self):
        return []

    def reference_mesh(self):
        return None

    def close(self) -> None:
        self.plan = self.mesh = None


def setup(config, traffic, device, spans) -> Session:
    return Session(config, traffic, device, spans)
