"""The plain reference of the steady heat problem that every cell solves.

The system is the mesh's graph Laplacian with Dirichlet nodesets
eliminated: a node in any nodeset holds its set's temperature, every other
node is a degree of freedom, two nodes are neighbours when some element
holds both, and at a free node the temperature times the node's number of
neighbours equals the sum of its neighbours' temperatures.  Free nodes are
numbered by ascending node index.  With ``u`` the whole nodal field (the
answer on free nodes, the temperatures on the nodesets), the residual of an
answer at free node i is ``sum_j u_j - deg_i u_i`` over i's neighbours j,
and the right-hand side is the same sum over the nodeset neighbours alone.

Two forms, the same semantics:

- :class:`MeshHeat`, from a tetrahedral mesh's connectivity, with a SciPy
  sparse adjacency;
- :class:`BoxHeat`, of ``box_tet4(n, n, n)`` without building it: the
  neighbours of a box node follow from the cell parity's five tetrahedra,
  so the adjacency is 13 boolean lattice arrays, one per direction, and a
  product is shifted slices in float64 PyTorch, on the card or the CPU.
  Memory stays a few hundred MB at 10M nodes, where a SciPy matrix of the
  51M tetrahedra would not fit the time of a run.

Residuals are computed in float64, once the program's state has been
freed.  Nothing here imports the program or JAX.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np

from . import meshgen

__all__ = ["MeshHeat", "BoxHeat", "round_to_float16"]


def round_to_float16(x: np.ndarray) -> np.ndarray:
    """``x`` (float32) held in float16 (nearest, ties to even), as
    float64."""
    return np.asarray(x, dtype=np.float32).astype(np.float16).astype(
        np.float64)


class MeshHeat:
    """The reference on a tetrahedral mesh (``meshgen.TetMesh``)."""

    def __init__(self, mesh: meshgen.TetMesh):
        import scipy.sparse as sp

        n = mesh.num_nodes
        keys, _inv = meshgen.unique_edges(mesh.conn, n)
        lo, hi = keys // n, keys % n
        ones = np.ones(2 * keys.size, dtype=np.float64)
        self.adj = sp.csr_matrix(
            (ones, (np.concatenate([lo, hi]), np.concatenate([hi, lo]))),
            shape=(n, n))
        self.deg = np.diff(self.adj.indptr).astype(np.float64)
        self.node_sets = mesh.node_sets
        fixed = np.zeros(n, dtype=bool)
        for nodes in mesh.node_sets.values():
            fixed[nodes] = True
        self.free = np.flatnonzero(~fixed)
        self.n_nodes = n
        # Nonzeros of the eliminated operator: each free row's free
        # neighbours and its diagonal.
        both = int(np.count_nonzero(~fixed[lo] & ~fixed[hi]))
        self.nnz = 2 * both + int(self.free.size)

    @property
    def n_free(self) -> int:
        return int(self.free.size)

    def boundary_field(self, temps: Dict[int, float]) -> np.ndarray:
        """Whole nodal field with the nodesets' temperatures and 0 on free
        nodes; the smallest set id wins on a node in several sets."""
        u = np.zeros(self.n_nodes)
        for sid in sorted(self.node_sets, reverse=True):
            u[self.node_sets[sid]] = float(temps.get(sid, sid))
        u[self.free] = 0.0
        return u

    def relres(self, x_free: np.ndarray, temps: Dict[int, float]) -> float:
        """||b - A x|| / ||b|| of a free-node answer, in float64."""
        u = self.boundary_field(temps)
        b = (self.adj @ u)[self.free]
        u[self.free] = np.asarray(x_free, dtype=np.float64)
        r = (self.adj @ u)[self.free] - self.deg[self.free] * u[self.free]
        return float(np.linalg.norm(r) / np.linalg.norm(b))


def _box_directions():
    """The 13 lattice directions (dx, dy, dz) with the first nonzero
    component positive: every edge of the box is one of them."""
    out = []
    for d in itertools.product((-1, 0, 1), repeat=3):
        dz, dy, dx = d[0], d[1], d[2]
        first = next((c for c in (dz, dy, dx) if c), 0)
        if first > 0:
            out.append((dx, dy, dz))
    return out


class BoxHeat:
    """The reference on ``box_tet4(n, n, n)`` (nodesets 100 on x = 0 and
    1000 on x = 1), from the lattice, in float64 PyTorch on ``device``: on
    the card once the program's state is freed (a product at 10M nodes
    takes some hundreds of ms in NumPy, a few ms there), or on the CPU."""

    def __init__(self, n: int, bc_ids=(100, 1000), device="cpu"):
        import torch

        self.n = n
        m = n + 1  # nodes per axis
        self.shape = (m, m, m)  # (z, y, x)
        self.bc_ids = tuple(int(i) for i in bc_ids)
        self.device = torch.device(device)
        corners = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                   (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]  # (x, y, z)
        # Edges as (corner, direction) pairs, by cell parity; an edge is
        # kept at the end from which its direction points into the box.
        edges = {d: np.zeros(self.shape, dtype=bool)
                 for d in _box_directions()}
        ci = np.arange(n)
        par = (ci[:, None, None] + ci[None, :, None] + ci[None, None, :]) & 1
        for parity, tets in ((0, meshgen.TET5_EVEN), (1, meshgen.TET5_ODD)):
            pairs = set()
            for t in tets:
                for a, b in itertools.combinations(t, 2):
                    pa, pb = np.array(corners[a]), np.array(corners[b])
                    d = pb - pa
                    if next(c for c in d[::-1] if c) < 0:
                        pa, d = pb, -d
                    pairs.add((tuple(int(v) for v in pa),
                               tuple(int(v) for v in d)))
            cells = par == parity  # (z, y, x) of cells
            for (ox, oy, oz), d in pairs:
                edges[d][oz:oz + n, oy:oy + n, ox:ox + n] |= cells
        deg = np.zeros(self.shape, dtype=np.float64)
        free = np.ones(self.shape, dtype=bool)
        free[:, :, 0] = free[:, :, -1] = False
        nnz = int(free.sum())
        self.edges = {}
        for d, e in edges.items():
            if not e.any():
                continue
            src, dst = self._src(d), self._dst(d)
            deg += e
            deg[dst] += e[src]
            nnz += 2 * int((e[src] & free[src] & free[dst]).sum())
            self.edges[d] = torch.from_numpy(
                np.ascontiguousarray(e[src])).to(self.device)
        self.deg = torch.from_numpy(deg).to(self.device)
        self.n_free = (m - 2) * m * m
        # Nonzeros of the eliminated operator: each free row's free
        # neighbours and its diagonal.
        self.nnz = nnz

    def _src(self, d):
        """Slice of the nodes whose neighbour along ``d`` is in the box."""
        m = self.shape[0]
        return tuple(slice(max(0, -c), m - max(0, c)) for c in d[::-1])

    def _dst(self, d):
        m = self.shape[0]
        return tuple(slice(max(0, c), m - max(0, -c)) for c in d[::-1])

    def _neighbour_sum(self, u):
        import torch

        s = torch.zeros_like(u)
        for d, e in self.edges.items():
            src, dst = self._src(d), self._dst(d)
            s[src] += torch.where(e, u[dst], 0.0)
            s[dst] += torch.where(e, u[src], 0.0)
        return s

    def relres(self, x_free: np.ndarray, temps: Dict[int, float]) -> float:
        """||b - A x|| / ||b|| of a free-node answer (x fastest over the free
        grid (n - 1) x (n + 1) x (n + 1)), in float64."""
        import torch

        m = self.shape[0]
        u = torch.zeros(self.shape, dtype=torch.float64, device=self.device)
        u[:, :, 0] = float(temps.get(self.bc_ids[0], self.bc_ids[0]))
        u[:, :, -1] = float(temps.get(self.bc_ids[1], self.bc_ids[1]))
        b = self._neighbour_sum(u)[:, :, 1:-1]
        u[:, :, 1:-1] = torch.from_numpy(np.asarray(
            x_free, dtype=np.float64).reshape(m, m, m - 2)).to(self.device)
        r = (self._neighbour_sum(u) - self.deg * u)[:, :, 1:-1]
        return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))


def reference_for(config: dict, mesh: Optional[meshgen.TetMesh] = None,
                  device="cpu"):
    """The reference of a configuration, from its own parameters (and the
    mesh arrays the harness made from them, where it made a mesh); the
    lattice form runs on ``device``."""
    spec = config["mesh"]
    if spec["kind"] == "box_tet4_lattice":
        cells = [int(c) for c in spec["cells"]]
        if len(set(cells)) != 1:
            raise ValueError("the lattice reference takes a cube of cells")
        return BoxHeat(cells[0], device=device)
    if spec["kind"] == "box_tet4_refined":
        if mesh is None:
            mesh = meshgen.make_mesh(spec["cells"], int(spec["refine"]))
        return MeshHeat(mesh)
    raise ValueError(f"no reference for mesh kind {spec['kind']!r}")
