"""Deployment: the structured box over z-slabs, each process holding its
share of the slabs on its own device, the way the solver's
``--partitions N --precond amg`` route runs it across processes.

Set-up, on every process: ``structured_box_system`` (the host CSR the AMG
set-up reads), ``structured_box_parts`` on the device and
``pad_stencil_from_parts`` (kernel 3 over the whole box), then
``build_slab_pad_amg`` over the configuration's slabs on a mesh of every
process (``make_device_mesh``): the global brick hierarchy with each
slab's window as its fine level, the coarse tail run in every process.
Two entries, named by the traffic mix:

- ``refine``: ``slab_pad_amg_refine_solve``, f32 CG+AMG sweeps refined to
  an f64 tolerance, staging the right-hand side and the warm start and
  gathering the whole answer to every process itself;
- ``cg``: ``slab_pad_amg_cg_solve``, f32 CG+AMG on the same set-up, warm
  from the previous answer (the cell's control).

The client forms the right-hand side as ``structured_box.py`` does: each
face's temperature times its coupling, read once from the right-hand side
the program assembles for the nodesets' own ids.
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
        from domain_decomposed_pde_solver_tpu_torch.parallel import (
            make_device_mesh,
        )
        from domain_decomposed_pde_solver_tpu_torch.parallel.slabpadamg import (
            build_slab_pad_amg,
        )

        self.name = config["name"]
        self.device = torch.device(device)
        nx, ny, nz = (int(c) for c in config["mesh"]["cells"])
        ids = [int(i) for i in config["mesh"]["nodesets"]]
        nparts = int(config["slabs"]["parts"])

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        with spans.span("assembly"):
            sy = structured_box_system(nx, ny, nz, "TETRA4", bc_ids=tuple(ids))
        with spans.span("parts"):
            po = structured_box_parts(nx, ny, nz, "TETRA4",
                                      bc_ids=tuple(ids), device=self.device)
            sync()
        with spans.span("operator"):
            pad_op = pad_stencil_from_parts(po["parts"], device=self.device)
            sync()
        del po
        dims = (nx - 1, ny + 1, nz + 1)
        self.mesh = make_device_mesh(nparts, [self.device])
        with spans.span("amg_setup"):
            self.samg = build_slab_pad_amg(sy.A, dims, nparts, pad_op=pad_op,
                                           device=self.device, mesh=self.mesh)
            sync()
        if self.samg is None:
            raise RuntimeError(f"{self.name}: no slab layout of {nparts} "
                               f"parts for the free grid {dims}")
        # Face couplings: free rows on the first and the last x plane.
        mx = dims[0]
        b = np.asarray(sy.b, dtype=np.float64)
        col = np.arange(b.size) % mx
        self.rows = {ids[0]: np.flatnonzero(col == 0),
                     ids[1]: np.flatnonzero(col == mx - 1)}
        self.coupling = {i: b[r] / i for i, r in self.rows.items()}
        if np.count_nonzero(b) != sum(np.count_nonzero(c)
                                      for c in self.coupling.values()):
            raise RuntimeError("the right-hand side couples rows off the "
                               "two x faces")
        self.n_free = b.size
        del sy, b, col  # the host CSR is the set-up's alone
        self.use(traffic)

    def use(self, traffic) -> None:
        """Serve ``traffic``'s entry from now on, from a cold start (a
        control drives the other entry on the same set-up)."""
        self.entry = traffic["entry"]
        if self.entry not in ("refine", "cg"):
            raise ValueError(f"{self.name} has no entry {self.entry!r}")
        self.traffic = traffic
        dt = np.float64 if self.entry == "refine" else np.float32
        self.b = np.zeros(self.n_free, dtype=dt)
        self.x = None  # the previous answer, whole, on the host

    def prepare(self, temps) -> None:
        for i, r in self.rows.items():
            self.b[r] = float(temps[i]) * self.coupling[i]

    def request(self, temps) -> Answer:
        if self.entry == "refine":
            return self._refine()
        return self._cg()

    def _refine(self) -> Answer:
        from domain_decomposed_pde_solver_tpu_torch.parallel.slabpadmixed import (
            slab_pad_amg_refine_solve,
        )

        t = self.traffic
        mr = slab_pad_amg_refine_solve(
            self.samg, b=self.b, x0=self.x, mesh=self.mesh, tol=t["tol"],
            inner_tol=t["inner_tol"], inner_maxiter=t["inner_maxiter"])
        self.x = mr.x
        tm = mr.timings
        return Answer(x=mr.x, iterations=int(mr.inner_iterations),
                      converged=bool(mr.converged), solve_ms=tm["sweeps_ms"],
                      copy_ms=tm["stage_ms"] + tm["fetch_ms"])

    def _cg(self) -> Answer:
        from domain_decomposed_pde_solver_tpu_torch.parallel.slabpadamg import (
            slab_pad_amg_cg_solve,
        )

        t = self.traffic
        x0 = self.x if self.x is not None else np.zeros_like(self.b)
        x, res = slab_pad_amg_cg_solve(self.samg, self.b, x0, mesh=self.mesh,
                                       tol=t["tol"], maxiter=t["maxiter"])
        self.x = x
        return Answer(x=x, iterations=int(res.iterations),
                      converged=bool(res.converged))

    def fine_operators(self):
        return [("k3", "pad_stencil_kernel", self.samg.A)]

    def reference_mesh(self):
        return None

    def close(self) -> None:
        self.samg = self.mesh = self.x = None


def setup(config, traffic, device, spans) -> Session:
    return Session(config, traffic, device, spans)
