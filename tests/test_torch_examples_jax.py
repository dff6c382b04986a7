"""The port's example scripts print JAX's examples' numbers
(``examples/01``-``07`` against ``domain_decomposed_pde_solver_tpu_torch/
examples/``), held by ``chip_smoke.example_mismatches``, the rule phase K
holds the card to: iterations equal in float64 and within one in
float32, sweeps equal and inner iterations within one per sweep, a relres
within its printed precision (float32 and refined residuals, and FEM
errors: both within the tolerance the script solves to), every other
number as printed.

JAX's example runs in a subprocess as ``tests/test_examples.py`` runs it
(8 virtual devices), its Exodus writer pointed into a temporary
directory so that it never shares a file with that test's run; its runs
of 06 and 07 are ``slow``, as there.
"""

import pytest

import chip_smoke
from test_torch_examples import JAX_EXAMPLES, SCRIPTS, port_output, run_code

_JAX = (
    "import os, runpy, sys\n"
    "import domain_decomposed_pde_solver_tpu.io as io\n"
    "out = sys.argv[2]\n"
    "class Writer(io.ExodusSolutionWriter):\n"
    "    def __init__(self, path, *a, **k):\n"
    "        super().__init__(os.path.join(out, os.path.basename(path)), *a,"
    " **k)\n"
    "io.ExodusSolutionWriter = Writer\n"
    "script = sys.argv[1]\n"
    "sys.argv = [script]\n"
    "runpy.run_path(script, run_name='__main__')\n"
)


@pytest.mark.parametrize("script", [
    *SCRIPTS[:5],
    *(pytest.param(s, marks=pytest.mark.slow) for s in SCRIPTS[5:])])
def test_port_example_matches_jax(script, tmp_path):
    jax_out = run_code(_JAX, JAX_EXAMPLES / script, tmp_path)
    bad = chip_smoke.example_mismatches(script, port_output(script), jax_out)
    assert bad == [], (port_output(script), jax_out)
