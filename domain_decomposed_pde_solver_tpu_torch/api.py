"""High-level session API: build once, solve many.

Counterpart of the JAX package's ``api.py``: the expensive artifacts (mesh,
assembly, device operator, AMG hierarchy) are built once per mesh; repeated
solves reuse them and warm-start from the previous solution.

    solver = SteadyHeatSolver(mesh, dtype=torch.float32)  # on the card
    u1, res1 = solver.solve()                           # reference BC values
    u2, res2 = solver.solve(bc={100: 80.0, 1000: 25.0})  # new values, warm

The BC override exploits linearity: the RHS for arbitrary per-nodeset
Dirichlet values is reassembled in O(nnz) on the host (the matrix never
changes), so each new solve costs only a preconditioned CG.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .io.mesh import MeshModel
from .models.heat import HeatSystem, assemble_heat_system
from .utils.device import resolve_device
from .utils.timers import span, spanned

__all__ = ["SteadyHeatSolver"]


class SteadyHeatSolver:
    """Reusable steady-state heat solver bound to one mesh and one device
    (``device`` defaults to the card; pass ``"cpu"`` for the CPU)."""

    def __init__(
        self,
        mesh: MeshModel,
        dtype=None,
        precond: str = "amg",
        device=None,
    ):
        from .ops.dia import choose_operator
        from .solvers.precond.amg import infer_free_grid

        if precond not in ("jacobi", "amg", "none"):
            raise ValueError(f"precond must be jacobi|amg|none, got {precond!r}")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.dtype = dtype if dtype is not None else torch.float64
        with span("setup.assembly"):
            self.system: HeatSystem = assemble_heat_system(mesh)
        # Fastest format for the mesh class, as JAX chooses: the lattice
        # stencil (f32) or DIA (f64) on lexicographic grids, the sliced-ELL
        # operator (RCM, the SpMV kernel) on unstructured meshes, which the
        # AMG hierarchy then takes as its fine level.
        self._grid_dims = infer_free_grid(mesh, self.system.free_to_node)
        with span("setup.operator"):
            self.operator = choose_operator(
                self.system.A, dtype=self.dtype, grid_dims=self._grid_dims,
                bsg="auto", device=self.device,
            )
        self._precond_kind = precond
        self._precond = self._build_precond(precond)
        self._last_x: Optional[np.ndarray] = None
        self._b_rows = self.system.bdry_rows
        self._b_cols = self.system.bdry_cols

    @classmethod
    def from_file(cls, path: str, **kw) -> "SteadyHeatSolver":
        from .io.exodus import read_exodus

        return cls(read_exodus(path), **kw)

    def _build_precond(self, kind: str):
        from .solvers.precond.jacobi import jacobi_preconditioner

        if kind == "jacobi":
            return jacobi_preconditioner(self.operator)
        if kind == "amg":
            from .ops.bsg import BSGMatrix
            from .solvers.precond.amg import smoothed_aggregation_setup

            return smoothed_aggregation_setup(
                self.system.A,
                dtype=self.dtype,
                grid_dims=self._grid_dims,
                fine_operator=(self.operator
                               if isinstance(self.operator, BSGMatrix)
                               else None),
                device=self.device,
            )
        return None

    @spanned("request.rhs")
    def rhs_for(self, bc: Optional[Dict[int, float]] = None) -> np.ndarray:
        """RHS for per-nodeset Dirichlet values.

        ``bc`` maps nodeset id -> temperature; omitted sets keep the
        reference convention (value = nodeset id, smallest id winning for
        multiply-set nodes)."""
        if not bc:
            return self.system.b
        self._check_bc_ids(bc)
        # Descending-id overwrite => ascending-id priority for multiply-set
        # nodes, the reference's tie-break.
        bval = np.zeros(self.mesh.num_nodes)
        for ns in sorted(self.mesh.node_sets, key=lambda s: s.id, reverse=True):
            bval[ns.nodes.astype(np.int64)] = float(bc.get(ns.id, ns.id))
        b = np.zeros(self.system.n_free)
        np.add.at(b, self._b_rows, bval[self._b_cols])
        return b

    def _check_bc_ids(self, bc: Dict[int, float]) -> None:
        known = {ns.id for ns in self.mesh.node_sets}
        unknown = set(bc) - known
        if unknown:
            raise ValueError(
                f"bc references nodeset ids {sorted(unknown)} not present in "
                f"the mesh (available: {sorted(known)})"
            )

    def boundary_values_for(self, bc: Optional[Dict[int, float]] = None) -> np.ndarray:
        """Per-node values for Exodus timestep-0 output under ``bc``."""
        if bc:
            self._check_bc_ids(bc)
        vals = np.zeros(self.mesh.num_nodes)
        # Ascending-id overwrite => largest id wins for multiply-set nodes
        # (the reference's write-side tie-break).
        for ns in sorted(self.mesh.node_sets, key=lambda s: s.id):
            vals[ns.nodes.astype(np.int64)] = float(
                (bc or {}).get(ns.id, ns.id)
            )
        return vals

    @spanned("request")
    def solve(
        self,
        bc: Optional[Dict[int, float]] = None,
        tol: float = 1e-10,
        maxiter: int = 1000,
        warm_start: bool = True,
    ):
        """Solve for the given boundary temperatures; returns
        ``(u_free, CGResult)`` with ``u_free`` a host numpy vector."""
        from .solvers.cg import cg_solve

        b = self.operator.put_vector(self.rhs_for(bc), dtype=self.dtype)
        if warm_start and self._last_x is not None:
            x0 = self.operator.put_vector(self._last_x, dtype=self.dtype)
        else:
            x0 = torch.zeros_like(b)
        res = cg_solve(
            self.operator, b, x0, precond=self._precond, tol=tol,
            maxiter=maxiter,
        )
        u = self.operator.get_vector(res.x)
        self._last_x = np.array(u)
        return u, res

    def write_solution(self, path: str, u: np.ndarray,
                       bc: Optional[Dict[int, float]] = None,
                       timestep: int = 0) -> None:
        """Write ``u`` (free-node values) as an Exodus solution file."""
        from .io.exodus import ExodusSolutionWriter

        with ExodusSolutionWriter(
            path, self.mesh, boundary_values=self.boundary_values_for(bc)
        ) as w:
            w.write_solution(u, self.system.free_to_node, timestep)
