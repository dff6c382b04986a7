"""Mesh I/O: Exodus-II (netCDF3) ingest/egress and the in-memory mesh model."""

from .mesh import ElemBlock, MeshModel, NodeSet, SideSet, elem_type_ncommon
from .exodus import (
    ExodusReadError,
    ExodusSolutionWriter,
    read_exodus,
    read_nodal_vars,
    write_exodus,
)
from .boxmesh import box_mesh
from .refine import refine_uniform
from .sides import nodesets_from_sidesets, side_local_nodes, sideset_nodes

__all__ = [
    "ElemBlock",
    "MeshModel",
    "NodeSet",
    "SideSet",
    "elem_type_ncommon",
    "ExodusReadError",
    "ExodusSolutionWriter",
    "read_exodus",
    "read_nodal_vars",
    "write_exodus",
    "box_mesh",
    "refine_uniform",
    "nodesets_from_sidesets",
    "side_local_nodes",
    "sideset_nodes",
]
