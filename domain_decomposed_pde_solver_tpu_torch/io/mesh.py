"""In-memory unstructured-mesh model (Exodus-II semantics).

This is the TPU-framework analogue of the mesh state the reference keeps
inside ``ExodusIO::IO`` (``ExodusIO.hpp:83-2225``): element blocks with
connectivity, nodesets, sidesets, id maps, coordinates, QA/info records.
Unlike the reference (which re-reads the Exodus file on every operation),
the model is a plain immutable-ish dataclass that every other layer
(assembly, partitioning, writers) consumes.

All connectivity and set arrays are **0-based** NumPy arrays; the Exodus
file format is 1-based and the io layer converts at the boundary
(the reference does the same with ``node_list[j]-1``, ``ExodusIO.hpp:187``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ElemBlock",
    "NodeSet",
    "SideSet",
    "MeshModel",
    "ELEM_TYPE_NUM_COMMON_NODES",
    "elem_type_ncommon",
    "boundary_value_from_sets",
]


def boundary_value_from_sets(num_nodes: int, node_sets):
    """``(is_boundary, bval)`` from a nodeset list (see
    :meth:`MeshModel.boundary_value_per_node` for the tie-break
    semantics).  A free function so distributed assembly can classify
    nodes from :func:`..io.exodus.read_exodus_node_data` output without a
    full :class:`MeshModel`."""
    import numpy as np

    is_boundary = np.zeros(num_nodes, dtype=bool)
    bval = np.zeros(num_nodes, dtype=np.float64)
    for ns in sorted(node_sets, key=lambda s: s.id, reverse=True):
        nodes = ns.nodes.astype(np.int64)
        is_boundary[nodes] = True
        # Iterating in descending id order and overwriting leaves the
        # smallest id in bval for nodes that sit in multiple sets.
        bval[nodes] = float(ns.id)
    return is_boundary, bval

# ncommonnodes for the dual graph, per element family — mirrors the mapping
# the reference feeds ParMETIS/METIS (``ExodusIO.hpp:909-918, :1603-1613``):
# TETRA->3, TRI->2, HEX->4.
ELEM_TYPE_NUM_COMMON_NODES = {
    "TETRA": 3,
    "TET": 3,
    "TETRA4": 3,
    "TET4": 3,
    "TRI": 2,
    "TRI3": 2,
    "TRIANGLE": 2,
    "HEX": 4,
    "HEX8": 4,
    "QUAD": 2,
    "QUAD4": 2,
}


def elem_type_ncommon(elem_type: str) -> int:
    """Number of shared nodes that makes two elements dual-graph neighbors."""
    key = elem_type.strip().upper()
    if key in ELEM_TYPE_NUM_COMMON_NODES:
        return ELEM_TYPE_NUM_COMMON_NODES[key]
    # Fall back by family prefix (e.g. "TETRA10").
    for prefix, n in (("TETRA", 3), ("TET", 3), ("TRI", 2), ("HEX", 4), ("QUAD", 2)):
        if key.startswith(prefix):
            return n
    raise ValueError(f"unknown element type {elem_type!r}")


@dataclasses.dataclass
class ElemBlock:
    """One Exodus element block (``ex_get_block``/``connect{i}`` variable)."""

    id: int
    elem_type: str
    conn: np.ndarray  # (num_elem, nodes_per_elem) int32/int64, 0-based
    name: str = ""
    attributes: Optional[np.ndarray] = None  # (num_elem, num_attr) float64

    @property
    def num_elem(self) -> int:
        return int(self.conn.shape[0])

    @property
    def nodes_per_elem(self) -> int:
        return int(self.conn.shape[1])


@dataclasses.dataclass
class NodeSet:
    """One Exodus nodeset: the Dirichlet-boundary marker of the reference.

    The reference reads these into ``nodeSetMap: id -> set<node>``
    (``ExodusIO.hpp:173-192``); the nodeset *id* doubles as the Dirichlet
    temperature value (``ExodusIO.hpp:671-687``).
    """

    id: int
    nodes: np.ndarray  # (n,) 0-based node indices
    name: str = ""
    dist_factors: Optional[np.ndarray] = None


@dataclasses.dataclass
class SideSet:
    """One Exodus sideset (kept for round-trip fidelity; the reference only
    copies them through in ``decompose``, ``ExodusIO.hpp:1853-1917``)."""

    id: int
    elems: np.ndarray  # (n,) 0-based element indices (global element order)
    sides: np.ndarray  # (n,) 1-based side-of-element numbers (Exodus convention)
    name: str = ""
    dist_factors: Optional[np.ndarray] = None


@dataclasses.dataclass
class MeshModel:
    """A whole Exodus-II mesh in memory."""

    coords: np.ndarray  # (num_nodes, num_dim) float64
    blocks: List[ElemBlock]
    node_sets: List[NodeSet] = dataclasses.field(default_factory=list)
    side_sets: List[SideSet] = dataclasses.field(default_factory=list)
    title: str = ""
    num_dim: Optional[int] = None  # may exceed coords dim (exodus stores 3D coords for 2D meshes)
    node_id_map: Optional[np.ndarray] = None  # Exodus ids, (num_nodes,)
    elem_id_map: Optional[np.ndarray] = None  # Exodus ids, (num_elem,)
    coord_names: Optional[Sequence[str]] = None
    qa_records: List[Tuple[str, str, str, str]] = dataclasses.field(default_factory=list)
    info_records: List[str] = dataclasses.field(default_factory=list)

    # ---- basic sizes -------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return int(self.coords.shape[0])

    @property
    def num_elem(self) -> int:
        return sum(b.num_elem for b in self.blocks)

    @property
    def dim(self) -> int:
        return int(self.num_dim if self.num_dim is not None else self.coords.shape[1])

    # ---- derived views ----------------------------------------------
    def node_set_map(self) -> Dict[int, np.ndarray]:
        """``nodeset id -> sorted unique 0-based node array`` (the reference's
        ``nodeSetMap``, ``ExodusIO.hpp:173-192``)."""
        return {ns.id: np.unique(ns.nodes.astype(np.int64)) for ns in self.node_sets}

    def boundary_value_per_node(self) -> Tuple[np.ndarray, np.ndarray]:
        """Return ``(is_boundary, bval)`` with the reference's tie-breaks.

        ``is_boundary[n]`` is True iff node ``n`` is in any nodeset
        (``ExodusIO.hpp:216-235``).  ``bval[n]`` is the nodeset id used when
        node ``n`` contributes to the RHS: the **smallest** nodeset id that
        contains it, because the reference iterates ``std::map`` in ascending
        key order and breaks at the first hit (``ExodusIO.hpp:675-682``).
        """
        return boundary_value_from_sets(self.num_nodes, self.node_sets)

    def boundary_write_values(self) -> np.ndarray:
        """Per-node values for solution timestep 0 (boundary snapshot).

        The reference fills ``node_vals[node] = nodeset id`` iterating the
        map in **ascending** id order without break (``ExodusIO.hpp:1979-1989``),
        so for multiply-set nodes the **largest** id wins here (note this is
        the opposite tie-break from :meth:`boundary_value_per_node`).
        """
        vals = np.zeros(self.num_nodes, dtype=np.float64)
        for ns in sorted(self.node_sets, key=lambda s: s.id):
            vals[ns.nodes.astype(np.int64)] = float(ns.id)
        return vals

    def all_connectivity(self) -> List[np.ndarray]:
        """Connectivity arrays of every block, in block order."""
        return [b.conn for b in self.blocks]

    def global_elem_offsets(self) -> np.ndarray:
        """Starting global element index of each block (Exodus global element
        order = concatenation of blocks in file order)."""
        sizes = np.array([b.num_elem for b in self.blocks], dtype=np.int64)
        return np.concatenate([[0], np.cumsum(sizes)[:-1]])

    def validate(self) -> None:
        n = self.num_nodes
        for b in self.blocks:
            if b.conn.size and (b.conn.min() < 0 or b.conn.max() >= n):
                raise ValueError(f"block {b.id}: connectivity out of range [0,{n})")
        for ns in self.node_sets:
            if ns.nodes.size and (ns.nodes.min() < 0 or ns.nodes.max() >= n):
                raise ValueError(f"nodeset {ns.id}: node out of range [0,{n})")
        ne = self.num_elem
        for ss in self.side_sets:
            if ss.elems.size and (ss.elems.min() < 0 or ss.elems.max() >= ne):
                raise ValueError(f"sideset {ss.id}: element out of range [0,{ne})")
