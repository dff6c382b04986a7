"""The port's package exports against the JAX package's.

For every name in the ``__all__`` of a JAX subpackage, either the port
defines it, and then exports it by the same import path and lists it in
its own ``__all__``, or it stands below among the names not ported by
design, with the reason.  A name the port comes to define must move out
of that list.
"""

import importlib
import pkgutil
import re
import types
import warnings

import numpy as np
import pytest

JAX = "domain_decomposed_pde_solver_tpu"
PORT = "domain_decomposed_pde_solver_tpu_torch"

BY_DESIGN = "not ported by design (ROADMAP.md North star)"

NOT_PORTED = {
    "io": {},
    "models": {},
    "ops": {
        "HYBMatrix": BY_DESIGN,
        "hyb_from_csr": BY_DESIGN,
        "SplitELLMatrix": BY_DESIGN,
        "splitell_from_csr": BY_DESIGN,
    },
    "parallel": {},
    "solvers": {},
    "solvers.precond": {},
    "utils": {
        "enable_persistent_cache": BY_DESIGN + ": nvcc builds are cached "
                                               "in build/kernels/",
    },
}


def _port_definitions(sub: str) -> dict:
    """Every class and function defined in a module of the port's
    subpackage ``sub``, by name."""
    pkg = importlib.import_module(f"{PORT}.{sub}")
    found = {}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) == mod.__name__:
                found.setdefault(name, obj)
    return found


@pytest.mark.parametrize("sub", sorted(NOT_PORTED))
def test_jax_exports_import_from_the_port(sub):
    jax_all = importlib.import_module(f"{JAX}.{sub}").__all__
    port = importlib.import_module(f"{PORT}.{sub}")
    defined = _port_definitions(sub)
    not_ported = NOT_PORTED[sub]
    assert set(not_ported) <= set(jax_all), "stale names in NOT_PORTED"
    for name in jax_all:
        if name in not_ported:
            assert name not in defined, (
                f"{sub}.{name} is defined in the port now: export it and "
                "take it out of NOT_PORTED")
            continue
        assert name in defined, f"{sub}.{name} is neither ported nor listed"
        assert name in port.__all__, f"{sub}.__all__ lacks {name}"
        got = getattr(importlib.import_module(f"{PORT}.{sub}"), name)
        assert got is defined[name]


@pytest.mark.parametrize("sub", sorted(NOT_PORTED))
def test_port_all_names_resolve(sub):
    port = importlib.import_module(f"{PORT}.{sub}")
    assert len(set(port.__all__)) == len(port.__all__)
    for name in port.__all__:
        assert hasattr(port, name), f"{sub}.__all__ names missing {name}"


def test_top_level_imports_the_subpackages():
    """JAX's ``__init__.py:41``: ``from . import io, models, ops, parallel,
    solvers, utils`` and ``SteadyHeatSolver``."""
    port = importlib.import_module(PORT)
    for sub in ("io", "models", "ops", "parallel", "solvers", "utils"):
        assert isinstance(getattr(port, sub), types.ModuleType)
    assert port.SteadyHeatSolver.__module__ == f"{PORT}.api"


def test_heat_warning_names_modules_the_port_has():
    """The no-nodeset warning of ``models/heat.py`` points at modules and
    functions the port defines."""
    from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
    from domain_decomposed_pde_solver_tpu_torch.models import (
        assemble_heat_system,
    )

    mesh = box_mesh(3, 3, 3, elem_type="TETRA4")
    mesh.node_sets = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sy = assemble_heat_system(mesh)
    assert not np.any(sy.b)
    text = " ".join(str(w.message) for w in caught)
    names = re.findall(r"\b((?:io|models)(?:\.\w+)+)", text)
    assert {"models.laplacian", "io.sides.nodesets_from_sidesets"} <= set(
        names), text
    for dotted in names:
        parts = dotted.split(".")
        try:
            importlib.import_module(f"{PORT}.{dotted}")
        except ModuleNotFoundError:
            mod = importlib.import_module(f"{PORT}.{'.'.join(parts[:-1])}")
            assert callable(getattr(mod, parts[-1]))
