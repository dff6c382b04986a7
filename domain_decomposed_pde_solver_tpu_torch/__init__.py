"""PyTorch/CUDA port of the domain-decomposed PDE solver.

A second package beside the JAX reference (``domain_decomposed_pde_solver_tpu``)
for NVIDIA Hopper GPUs.  It imports ``torch`` and never ``jax``; host-only
modules (mesh I/O, assembly, CSR, the native host library's loader) are
carried over as its own numpy code, and the TPU's Pallas kernels become
kernels written by hand for Hopper (``csrc/``).

Subpackages mirror the JAX package's module paths:

- ``io``: Exodus-II reader/writer, box meshes, uniform refinement and
  sideset resolution.
- ``models``: steady-state heat, the full-mesh Laplacian, P1/P2/Q2 finite
  elements with flux boundaries, transient heat flow.
- ``ops``: host CSR, the sliced-ELL, DIA and lattice-stencil (padded 3-D)
  operators and their CUDA kernels, ELL, operator choice.
- ``solvers``: CG (with per-iteration snapshots, or checkpointed and
  resumable), GMRES, BiCGStab, the fused Jacobi-PCG, Jacobi, Chebyshev,
  ILU and smoothed-aggregation AMG preconditioning, mixed-precision
  iterative refinement, the power method and Lanczos.
- ``parallel``: partitioners and the block-per-partition mesh writer,
  halo and slab plans, the partitioned operators, solvers and
  preconditioners, over one process or several (``torch.distributed``).
- ``cli``: the solve driver and the reference's other executables.
- ``utils``: device resolution (the card unless the CPU is asked for), the
  native host library, phase timers and profiler traces, host allocator
  tuning, configuration, debug dumps, adoption of the JAX package's
  arrays.
"""

__version__ = "0.1.0"

# Host allocator tuning: glibc's default mmap threshold makes every large
# NumPy temporary of the host assembly and set-up pay its page faults
# again.  Enabled at import, as the JAX package does; opt out with
# DDPS_NO_MALLOC_TUNING=1 (utils/hostmem.py).
from .utils.hostmem import enable_malloc_reuse as _emr  # noqa: E402

_emr()
del _emr

from . import io, models, ops, parallel, solvers, utils  # noqa: E402,F401
from .api import SteadyHeatSolver  # noqa: E402,F401
