"""Deployment: the session API, ``SteadyHeatSolver``, on a generated mesh.

Build once, solve many: the mesh is assembled, its operator and AMG
hierarchy set up once, and each request is
``solve(bc={set id: temperature}, tol, maxiter)``, warm from the previous
answer; the program forms the right-hand side itself (``rhs_for``).

The mesh comes from the benchmark's own generator
(``reference/meshgen.py``), kept in one fixed file under the checkout's
``build/portbench/`` after the first run, and is handed to the program as
its ``MeshModel``.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib

import numpy as np

from ..reference import meshgen
from . import Answer

CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "portbench"


def mesh_arrays(spec: dict, cache_dir=CACHE_DIR) -> meshgen.TetMesh:
    """The configuration's mesh, from the cache file when it is there."""
    key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()
                         + pathlib.Path(meshgen.__file__).read_bytes())
    path = pathlib.Path(cache_dir) / f"mesh-{key.hexdigest()[:16]}.npz"
    if path.exists():
        with np.load(path) as z:
            sets = {int(k[3:]): z[k] for k in z.files if k.startswith("ns_")}
            return meshgen.TetMesh(coords=z["coords"], conn=z["conn"],
                                   node_sets=sets)
    mesh = meshgen.make_mesh(spec["cells"], int(spec["refine"]))
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, coords=mesh.coords, conn=mesh.conn,
             **{f"ns_{k}": v for k, v in mesh.node_sets.items()})
    os.replace(tmp, path)
    return mesh


def mesh_model(mesh: meshgen.TetMesh):
    from domain_decomposed_pde_solver_tpu_torch.io.mesh import (
        ElemBlock,
        MeshModel,
        NodeSet,
    )

    return MeshModel(
        coords=mesh.coords,
        blocks=[ElemBlock(id=1, elem_type="TETRA4", conn=mesh.conn,
                          name="box")],
        node_sets=[NodeSet(id=k, nodes=v) for k, v in
                   sorted(mesh.node_sets.items())],
        title="benchmark mesh", num_dim=3)


class Session:
    def __init__(self, config, traffic, device, spans):
        import torch

        from domain_decomposed_pde_solver_tpu_torch import SteadyHeatSolver

        if traffic["entry"] != "session_solve":
            raise ValueError(f"{config['name']} has no entry "
                             f"{traffic['entry']!r}")
        self.traffic = traffic
        with spans.span("mesh"):
            self.mesh = mesh_arrays(config["mesh"])
        route = config["route"]
        with spans.span("solver_setup"):
            self.solver = SteadyHeatSolver(
                mesh_model(self.mesh), dtype=getattr(torch, route["dtype"]),
                precond=route["precond"], device=device)
            if self.solver.device.type == "cuda":
                torch.cuda.synchronize(self.solver.device)
        self.spans = spans
        self._unwrap = None
        if spans.tracing:
            self._wrap_cg(spans)

    def _wrap_cg(self, spans) -> None:
        """In a traced run, a span around the session's call into the CG
        loop (``api.py`` imports ``solvers.cg.cg_solve`` at each call)."""
        from domain_decomposed_pde_solver_tpu_torch.solvers import cg

        inner = cg.cg_solve

        def cg_solve(*args, **kw):
            with spans.span("solve") as s:
                out = inner(*args, **kw)
            self._solve_ms = s.ms
            return out

        cg.cg_solve = cg_solve
        self._unwrap = lambda: setattr(cg, "cg_solve", inner)

    def prepare(self, temps) -> None:
        pass

    def request(self, temps) -> Answer:
        self._solve_ms = None
        u, res = self.solver.solve(bc=dict(temps), tol=self.traffic["tol"],
                                   maxiter=self.traffic["maxiter"])
        return Answer(x=u, iterations=int(res.iterations),
                      converged=bool(res.converged), solve_ms=self._solve_ms)

    def fine_operators(self):
        return [("k1", "sell_spmv_kernel", self.solver.operator)]

    def reference_mesh(self):
        return self.mesh

    def close(self) -> None:
        if self._unwrap is not None:
            self._unwrap()
        self.solver = None


def setup(config, traffic, device, spans) -> Session:
    return Session(config, traffic, device, spans)
