"""Utilities: explicit device resolution, configuration and flags, debug
dumps and the output combiner, phase timers and profiler traces,
checkpoints, the native host library, host allocator tuning, the kernel
build cache, and adoption of the JAX package's arrays."""

from .compilecache import enable_persistent_cache
from .config import SolveConfig, add_solve_args, config_from_args
from .device import resolve_device
from .hostmem import enable_malloc_reuse
from .logging import combine_outputs, print_csr_matrix, print_vector
from .timers import PhaseTimer, trace_to

__all__ = [
    "resolve_device",
    "SolveConfig",
    "add_solve_args",
    "config_from_args",
    "combine_outputs",
    "print_csr_matrix",
    "print_vector",
    "PhaseTimer",
    "enable_malloc_reuse",
    "enable_persistent_cache",
    "trace_to",
]
