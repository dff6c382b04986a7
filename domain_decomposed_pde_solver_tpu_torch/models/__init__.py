"""PDE problem definitions: steady-state heat, the full-mesh Laplacian, P1,
P2 and Q2 finite elements, transient heat flow."""

from .heat import HeatSystem, assemble_heat_system, unique_element_edges
from .laplacian import assemble_full_laplacian
from .p2 import assemble_poisson_p2, elevate_to_p2
from .q2 import assemble_poisson_q2, elevate_to_q2
from .poisson_fem import assemble_poisson_fem, surface_load, surface_mass_coo
from .transient import TransientResult, transient_heat_solve

__all__ = [
    "HeatSystem",
    "assemble_heat_system",
    "unique_element_edges",
    "assemble_full_laplacian",
    "assemble_poisson_fem",
    "assemble_poisson_p2",
    "elevate_to_p2",
    "assemble_poisson_q2",
    "elevate_to_q2",
    "surface_load",
    "surface_mass_coo",
    "TransientResult",
    "transient_heat_solve",
]
