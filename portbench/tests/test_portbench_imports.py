"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program; top-level module names are
compared whole (the program's name begins with the JAX package's)."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
JAX = {"jax", "jaxlib", "flax", "domain_decomposed_pde_solver_tpu"}


def _top_names(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


PRINT = ("import sys, json; print(json.dumps(sorted({m.split('.')[0] "
         "for m in sys.modules})))")


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import sys, time, pathlib, shutil, json
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})
import portbench.run, portbench.control
from portbench import harness
from test_portbench_layout import tiny_root
root = tiny_root(pathlib.Path({str(tmp_path)!r}))
for cell in ("tet833k.sweep", "box10m.cg", "box10m.refine"):
    out = harness.run_cell(harness.load_cell(cell, root), 1, 0.2, True,
                           "cpu", time.perf_counter(), root)
    assert out["correct"]
{PRINT}
"""
    names = _top_names(code)
    assert "domain_decomposed_pde_solver_tpu_torch" in names
    assert not names & JAX


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import numpy as np
from portbench.reference import heat, meshgen
m = meshgen.make_mesh((4, 4, 4), 1)
r = heat.MeshHeat(m)
r.relres(np.zeros(r.n_free), {{100: 1.0, 1000: 2.0}})
b = heat.BoxHeat(8)
b.relres(np.zeros(b.n_free), {{100: 1.0, 1000: 2.0}})
{PRINT}
"""
    names = _top_names(code)
    assert not {n for n in names
                if n.startswith("domain_decomposed_pde_solver_tpu")}
    assert not names & JAX
