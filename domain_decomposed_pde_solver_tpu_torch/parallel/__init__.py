"""Domain decomposition: partitioners, halo plans, partitioned operators
and solvers.

The host partitioners and the block-per-partition mesh writer are numpy
copies of the JAX package's modules.  The domain-decomposed solve runs
every part on one device, one controller over P parts
(``parallel/sharded.py``): over a general halo plan, the sharded
operators and Krylov solvers, the block-Schwarz AMG and ILU
preconditioners and the global halo AMG; over z-slabs of a structured
grid, the slab DIA, lattice-stencil and pad-stencil (kernel 3 per slab)
operators, the brick-Schwarz preconditioner, the global slab AMG on
either fine level and the f64 refinement over the slabs.  Over several
processes (``torch.distributed``, :mod:`.multihost`), each process runs
the same programs over its own parts (:mod:`.collectives`); the
distributed assembly is :mod:`.distassembly` (not exported, as in JAX)."""

from .decompose import decompose_mesh, write_decomposition
from .halo import HaloPlan, build_halo_plan
from .multihost import initialize_multihost, multihost_slab_cg_solve, put_global
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
from .slab import (
    SlabDIAPlan,
    SlabStencilOperator,
    build_slab_plan,
    build_slab_stencil,
    slab_cg_solve,
    slab_stencil_cg_solve,
)
from .slabamg import SlabAMG, build_slab_amg, slab_amg_cg_solve
from .slabbrick import SlabBrickPrecond, build_slab_brick_precond
from .slabpad import (
    SlabPadPlan,
    SlabPadStencilOperator,
    build_slab_pad_stencil,
    slab_pad_cg_solve,
)
from .slabpadamg import SlabPadAMG, build_slab_pad_amg, slab_pad_amg_cg_solve
from .slabpadmixed import slab_pad_amg_refine_solve
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
    "SlabDIAPlan",
    "SlabStencilOperator",
    "build_slab_plan",
    "build_slab_stencil",
    "slab_cg_solve",
    "slab_stencil_cg_solve",
    "SlabAMG",
    "build_slab_amg",
    "slab_amg_cg_solve",
    "SlabBrickPrecond",
    "build_slab_brick_precond",
    "SlabPadPlan",
    "SlabPadStencilOperator",
    "build_slab_pad_stencil",
    "slab_pad_cg_solve",
    "SlabPadAMG",
    "build_slab_pad_amg",
    "slab_pad_amg_cg_solve",
    "slab_pad_amg_refine_solve",
    "BSGShardedOperator",
    "ShardedOperator",
    "make_device_mesh",
    "sharded_cg_chunk",
    "sharded_cg_solve",
    "sharded_gmres_solve",
    "sharded_power_method",
    "initialize_multihost",
    "multihost_slab_cg_solve",
    "put_global",
]
