"""What an installed port needs, read from ``pyproject.toml`` (no wheel is
built: ``pip wheel .`` would write ``build/lib`` and an ``*.egg-info``
into the tree).

- Package data: every file a kernel source includes by a quoted
  ``#include "..."``, and every source ``ops/_kernels.py::KERNELS`` builds,
  matches a package-data glob of the port, so ``nvcc`` finds them in an
  installed copy as in a checkout.
- Console scripts: the port's five ``ddps-torch-*`` entries point into the
  port; each target imports with ``jax`` blocked, is callable, and
  ``main(["--help"])`` exits 0.  JAX's five ``ddps-*`` entries stay.
"""

import fnmatch
import pathlib
import re
import subprocess
import sys
import tomllib

import pytest

from domain_decomposed_pde_solver_tpu_torch.ops._kernels import KERNELS

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = "domain_decomposed_pde_solver_tpu_torch"
PKG = REPO / PORT
PORT_SCRIPTS = {
    "ddps-torch-solve": "solve",
    "ddps-torch-decompose": "decompose",
    "ddps-torch-assemble-test": "assemble_test",
    "ddps-torch-matrix-test": "matrix_test",
    "ddps-torch-combine": "combine",
}
JAX_SCRIPTS = {
    "ddps-solve": "solve",
    "ddps-decompose": "decompose",
    "ddps-assemble-test": "assemble_test",
    "ddps-matrix-test": "matrix_test",
    "ddps-combine": "combine",
}
INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _pyproject() -> dict:
    return tomllib.loads((REPO / "pyproject.toml").read_text())


def _shipped(rel: str) -> bool:
    """Whether ``rel`` (a path inside the port's package) matches one of
    its package-data globs."""
    globs = _pyproject()["tool"]["setuptools"]["package-data"][PORT]
    return any(fnmatch.fnmatch(rel, g) for g in globs)


def _csrc_files():
    return sorted([*PKG.glob("csrc/*.cu"), *PKG.glob("csrc/*.cuh")])


def test_every_quoted_include_is_package_data():
    files = _csrc_files()
    assert any(f.suffix == ".cuh" for f in files)
    missing = []
    for f in files:
        for inc in INCLUDE.findall(f.read_text()):
            target = (f.parent / inc).resolve()
            assert target.is_file(), f"{f.name} includes a missing {inc}"
            rel = target.relative_to(PKG).as_posix()
            if not _shipped(rel):
                missing.append(f"{f.name}: {rel}")
    assert missing == []


def test_every_kernel_source_is_package_data():
    assert len(KERNELS) == 5
    for k in KERNELS:
        rel = k.src.resolve().relative_to(PKG).as_posix()
        assert rel.startswith("csrc/") and _shipped(rel), rel


def test_an_unlisted_include_would_fail():
    """The check above is not vacuous: a header outside every glob is
    caught."""
    assert not _shipped("csrc/extra.h")
    assert _shipped("csrc/values.cuh") and _shipped("csrc/spmv.cu")


def test_jax_console_scripts_are_unchanged():
    scripts = _pyproject()["project"]["scripts"]
    for name, mod in JAX_SCRIPTS.items():
        assert scripts[name] == f"domain_decomposed_pde_solver_tpu.cli.{mod}:main"


# Blocks JAX and the JAX package in the child: an import of either raises.
_GUARD = (
    "import sys\n"
    "for m in ('jax', 'jaxlib', 'domain_decomposed_pde_solver_tpu'):\n"
    "    sys.modules[m] = None\n"
    "import importlib\n"
    "mod, _, fn = sys.argv[1].partition(':')\n"
    "main = getattr(importlib.import_module(mod), fn)\n"
    "assert callable(main), sys.argv[1]\n"
    "try:\n"
    "    code = main(['--help'])\n"
    "except SystemExit as exc:\n"
    "    code = exc.code\n"
    "assert code in (0, None), code\n"
    "bad = sorted(m for m in sys.modules if sys.modules[m] is not None and ("
    "m.split('.')[0] in ('jax', 'jaxlib', 'domain_decomposed_pde_solver_tpu')))\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)


@pytest.mark.parametrize("name", sorted(PORT_SCRIPTS))
def test_port_console_script(name):
    target = _pyproject()["project"]["scripts"][name]
    assert target == f"{PORT}.cli.{PORT_SCRIPTS[name]}:main"
    out = subprocess.run([sys.executable, "-c", _GUARD, target], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
    assert "usage:" in out.stdout
