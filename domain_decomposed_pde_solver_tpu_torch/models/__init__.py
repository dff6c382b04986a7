"""PDE problem definitions: the steady-state heat system."""

from .heat import HeatSystem, assemble_heat_system, unique_element_edges

__all__ = ["HeatSystem", "assemble_heat_system", "unique_element_edges"]
