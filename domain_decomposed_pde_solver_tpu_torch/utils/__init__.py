"""Utilities: explicit device resolution, configuration and flags, debug
dumps and the output combiner, phase timers, checkpoints, the native host
library, and adoption of the JAX package's arrays."""

from .config import SolveConfig, add_solve_args, config_from_args
from .device import resolve_device
from .logging import combine_outputs, print_csr_matrix, print_vector
from .timers import PhaseTimer

__all__ = [
    "resolve_device",
    "SolveConfig",
    "add_solve_args",
    "config_from_args",
    "combine_outputs",
    "print_csr_matrix",
    "print_vector",
    "PhaseTimer",
]
