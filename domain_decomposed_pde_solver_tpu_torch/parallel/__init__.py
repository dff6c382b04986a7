"""Domain decomposition: partitioners, halo plans, partitioned operators
and solvers.

The host partitioners and the block-per-partition mesh writer are numpy
copies of the JAX package's modules.  The domain-decomposed solve runs
every part of a halo plan on one device, one controller over P parts
(``parallel/sharded.py``): the sharded operators and Krylov solvers, the
block-Schwarz AMG and ILU preconditioners and the global halo AMG.  The
structured slab engines (``ROADMAP.md``, Queue 1, item 9b) and the
multi-process path (item 9c) are not ported yet."""

from .decompose import decompose_mesh, write_decomposition
from .halo import HaloPlan, build_halo_plan
from .haloamg import HaloAMG, build_halo_amg, halo_amg_cg_solve
from .ownership import node_ownership_from_element_partition
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
from .schwarz import build_block_amg
from .schwarzilu import build_block_ilu
from .sharded import (
    BSGShardedOperator,
    ShardedOperator,
    make_device_mesh,
    sharded_cg_chunk,
    sharded_cg_solve,
    sharded_gmres_solve,
    sharded_power_method,
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
    "HaloPlan",
    "build_halo_plan",
    "node_ownership_from_element_partition",
    "build_block_amg",
    "build_block_ilu",
    "HaloAMG",
    "build_halo_amg",
    "halo_amg_cg_solve",
    "BSGShardedOperator",
    "ShardedOperator",
    "make_device_mesh",
    "sharded_cg_chunk",
    "sharded_cg_solve",
    "sharded_gmres_solve",
    "sharded_power_method",
]
