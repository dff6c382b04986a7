"""Deployment: the structured route for a generated box, no mesh built.

``structured_box_system`` (the host CSR the AMG set-up reads),
``structured_box_parts`` on the device, ``pad_stencil_from_parts``
(kernel 3) and ``smoothed_aggregation_setup(..., fine_operator=A)``: a
brick AMG over the pad-stencil level 0.  Two entries, named by the traffic
mix:

- ``refine``: ``iterative_refinement_solve`` to an f64 tolerance with the
  f64 residual on the card, staging the right-hand side and the warm start
  and fetching the answer itself;
- ``cg``: ``put_vector`` of the right-hand side, f32 ``cg_solve`` warm
  from the previous answer on the card, ``get_vector``.

The program has no entry that takes temperatures, so the client keeps one
dense host right-hand side and, outside the timed request, rewrites the
rows coupled to the two faces: by linearity, each face's temperature times
its coupling, read once from the right-hand side the program assembles for
the nodesets' own ids.
"""

from __future__ import annotations

import numpy as np

from . import Answer


class Session:
    def __init__(self, config, traffic, device, spans):
        import torch

        from domain_decomposed_pde_solver_tpu_torch.models.structured import (
            structured_box_parts,
            structured_box_system,
        )
        from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
            pad_stencil_from_parts,
        )
        from domain_decomposed_pde_solver_tpu_torch.solvers.precond.amg import (
            smoothed_aggregation_setup,
        )

        self.name = config["name"]
        self.device = torch.device(device)
        nx, ny, nz = (int(c) for c in config["mesh"]["cells"])
        ids = [int(i) for i in config["mesh"]["nodesets"]]

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        with spans.span("assembly"):
            self.sy = structured_box_system(nx, ny, nz, "TETRA4",
                                            bc_ids=tuple(ids))
        with spans.span("parts"):
            po = structured_box_parts(nx, ny, nz, "TETRA4",
                                      bc_ids=tuple(ids), device=self.device)
            sync()
        with spans.span("operator"):
            self.A = pad_stencil_from_parts(po["parts"], device=self.device)
            sync()
        del po
        dims = (nx - 1, ny + 1, nz + 1)
        with spans.span("amg_setup"):
            self.M = smoothed_aggregation_setup(
                self.sy.A, dtype=torch.float32, grid_dims=dims,
                fine_operator=self.A, device=self.device)
            sync()
        # Face couplings: free rows on the first and the last x plane.
        mx = dims[0]
        b = np.asarray(self.sy.b, dtype=np.float64)
        col = np.arange(b.size) % mx
        self.rows = {ids[0]: np.flatnonzero(col == 0),
                     ids[1]: np.flatnonzero(col == mx - 1)}
        self.coupling = {i: b[r] / i for i, r in self.rows.items()}
        if np.count_nonzero(b) != sum(np.count_nonzero(c)
                                      for c in self.coupling.values()):
            raise RuntimeError("the right-hand side couples rows off the "
                               "two x faces")
        self.spans = spans
        self.use(traffic)

    def use(self, traffic) -> None:
        """Serve ``traffic``'s entry from now on, from a cold start (a
        control drives the other entry on the same set-up)."""
        self.entry = traffic["entry"]
        if self.entry not in ("refine", "cg"):
            raise ValueError(f"{self.name} has no entry {self.entry!r}")
        self.traffic = traffic
        dt = np.float64 if self.entry == "refine" else np.float32
        self.b = np.zeros(self.sy.n_free, dtype=dt)
        self.x_host = None  # refine: the previous answer
        self.x_dev = None  # cg: the previous answer on the card

    def prepare(self, temps) -> None:
        for i, r in self.rows.items():
            self.b[r] = float(temps[i]) * self.coupling[i]

    def request(self, temps) -> Answer:
        if self.entry == "refine":
            return self._refine()
        return self._cg()

    def _refine(self) -> Answer:
        from domain_decomposed_pde_solver_tpu_torch.solvers.mixed import (
            iterative_refinement_solve,
        )

        t = self.traffic
        mr = iterative_refinement_solve(
            self.sy.A, self.b, self.x_host, tol=t["tol"],
            inner_tol=t["inner_tol"], inner_maxiter=t["inner_maxiter"],
            precond=self.M, operator=self.A, device_residual=True)
        self.x_host = mr.x
        tm = mr.timings or {}
        copy = (tm["stage_ms"] + tm["fetch_ms"]) if tm else None
        return Answer(x=mr.x, iterations=int(mr.inner_iterations),
                      converged=bool(mr.converged),
                      solve_ms=tm.get("sweeps_ms"), copy_ms=copy)

    def _cg(self) -> Answer:
        import torch

        from domain_decomposed_pde_solver_tpu_torch.solvers.cg import cg_solve

        t, spans = self.traffic, self.spans
        with spans.span("put"):
            bd = self.A.put_vector(self.b, dtype=torch.float32)
        x0 = self.x_dev if self.x_dev is not None else torch.zeros_like(bd)
        with spans.span("solve") as s:
            res = cg_solve(self.A, bd, x0, precond=self.M, tol=t["tol"],
                           maxiter=t["maxiter"])
        with spans.span("get"):
            x = self.A.get_vector(res.x)
        self.x_dev = res.x
        return Answer(x=x, iterations=int(res.iterations),
                      converged=bool(res.converged), solve_ms=s.ms)

    def fine_operators(self):
        return [("k3", "pad_stencil_kernel", self.A)]

    def reference_mesh(self):
        return None

    def close(self) -> None:
        self.sy = self.A = self.M = self.x_dev = None


def setup(config, traffic, device, spans) -> Session:
    return Session(config, traffic, device, spans)
