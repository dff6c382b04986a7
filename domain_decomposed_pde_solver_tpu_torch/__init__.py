"""PyTorch/CUDA port of the domain-decomposed PDE solver.

A second package beside the JAX reference (``domain_decomposed_pde_solver_tpu``)
for NVIDIA Hopper GPUs.  It imports ``torch`` and never ``jax``; host-only
modules (mesh I/O, assembly, CSR, the native host library's loader) are
carried over as its own numpy code, and the TPU's Pallas kernels become
kernels written by hand for Hopper (``csrc/``).

Subpackages mirror the JAX package's module paths:

- ``io``: Exodus-II reader/writer, box meshes and uniform refinement.
- ``models``: steady-state heat assembly.
- ``ops``: host CSR, the sliced-ELL, DIA and lattice-stencil (padded 3-D)
  operators and their CUDA kernels, ELL, operator choice.
- ``solvers``: CG (with per-iteration snapshots), Jacobi and
  smoothed-aggregation AMG preconditioning, mixed-precision iterative
  refinement.
- ``parallel``: the element partitioner and the block-per-partition mesh
  writer.
- ``cli``: the solve driver.
- ``utils``: device resolution (the card unless the CPU is asked for), the
  native host library, phase timers, configuration, debug dumps, adoption
  of the JAX package's arrays.
"""

__version__ = "0.1.0"

from .api import SteadyHeatSolver  # noqa: E402,F401
