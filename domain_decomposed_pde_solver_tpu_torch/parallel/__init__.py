"""Host partitioning: the element partitioner and the block-per-partition
mesh writer (numpy copies of the JAX package's modules).  The multi-device
solvers are not ported yet (``ROADMAP.md``, Queue 1, item 9)."""

from .decompose import decompose_mesh, write_decomposition
from .partition import (
    PartitionStats,
    build_dual_graph,
    edgecut,
    partition_graph,
    partition_mesh_elements,
    partition_rcb,
    partition_stats,
    refine_partition,
)

__all__ = [
    "PartitionStats",
    "build_dual_graph",
    "edgecut",
    "partition_graph",
    "partition_stats",
    "decompose_mesh",
    "partition_mesh_elements",
    "partition_rcb",
    "refine_partition",
    "write_decomposition",
]
