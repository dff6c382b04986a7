"""The port's example scripts (``domain_decomposed_pde_solver_tpu_torch/
examples/``) run on the CPU and load no JAX; 06's count does not depend
on P; 02 over two processes prints its one-process lines; and the rule
that holds two runs' printed numbers
(``chip_smoke.example_mismatches``, phase K's and
``test_torch_examples_jax.py``'s) catches each kind of number.

Each port script runs with ``--cpu`` in a subprocess, through
``runpy.run_path`` with ``jax``, ``jaxlib`` and the JAX package blocked
in ``sys.modules``; afterwards none of them is loaded.
"""

import functools
import os
import pathlib
import subprocess
import sys
import tempfile

import pytest

import chip_smoke

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_EXAMPLES = REPO / "domain_decomposed_pde_solver_tpu_torch" / "examples"
JAX_EXAMPLES = REPO / "examples"
SCRIPTS = sorted(chip_smoke.EXAMPLES)

_PORT = (
    "import runpy, sys\n"
    "for m in ('jax', 'jaxlib', 'domain_decomposed_pde_solver_tpu'):\n"
    "    sys.modules[m] = None\n"
    "script = sys.argv[1]\n"
    "sys.argv = [script, '--cpu']\n"
    "runpy.run_path(script, run_name='__main__')\n"
    "bad = sorted(m for m in sys.modules if sys.modules[m] is not None and "
    "m.split('.')[0] in ('jax', 'jaxlib', 'domain_decomposed_pde_solver_tpu'))\n"
    "assert not bad, bad\n"
)
def _env() -> dict:
    env = dict(os.environ)
    # The suite's workers share the host: two threads per script.
    env["OMP_NUM_THREADS"] = "2"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    return env


def run_code(code: str, *args, tmp=None) -> str:
    env = _env()
    if tmp is not None:  # where the port's 01 and 04 write their files
        env["TMPDIR"] = str(tmp)
    proc = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@functools.lru_cache(maxsize=None)
def port_output(script: str) -> str:
    """The port script's output with ``--cpu`` (one run per worker), its
    files written into a directory of its own."""
    with tempfile.TemporaryDirectory() as tmp:
        return run_code(_PORT, PORT_EXAMPLES / script, tmp=tmp)


@pytest.mark.parametrize("script", SCRIPTS)
def test_port_example_runs_on_the_cpu_without_jax(script):
    lines = chip_smoke.example_numbers(port_output(script))
    kinds = {k for line in lines for k, _ in line}
    assert kinds & {"iterations", "inner"}, kinds


def test_port_examples_are_jax_examples_counterparts():
    assert SCRIPTS == sorted(p.name for p in JAX_EXAMPLES.glob("0*.py"))
    assert sorted(p.name for p in PORT_EXAMPLES.iterdir()
                  if p.suffix == ".py") == SCRIPTS
    assert not (PORT_EXAMPLES / "__init__.py").exists()


def test_06_count_does_not_depend_on_p():
    """06's claim: the partitioned hierarchy keeps the single-device
    count at every P (one device, then P = 2, 4 and 8)."""
    its = chip_smoke.p_counts(port_output("06_distributed_amg.py"))
    assert len(its) == 4 and len(set(its)) == 1, its


def test_02_over_two_processes_prints_its_one_process_lines(tmp_path):
    """02 under a launcher of two processes (the ``DDPS_*`` variables, a
    ``file://`` rendezvous): process 0 prints the one-process run's lines,
    the same iterations and residuals, and process 1 prints nothing."""
    script = PORT_EXAMPLES / "02_multi_device.py"
    procs = [subprocess.Popen(
        [sys.executable, str(script), "--cpu"], cwd=REPO,
        env=_env() | dict(OMP_NUM_THREADS="1",
                          DDPS_COORDINATOR=f"file://{tmp_path / 'rdv'}",
                          DDPS_NUM_PROCESSES="2", DDPS_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert outs[0][0] == port_output("02_multi_device.py")
    assert outs[1][0] == ""


@pytest.mark.parametrize("script,got,ref,ok", [
    ("01_basic_solve.py", "converged=True in 76 iterations",
     "converged=True in 77 iterations", False),
    ("06_distributed_amg.py", "P=2 sharded  : 10 iterations (relres 5.0e-07)",
     "P=2 sharded  : 9 iterations (relres 1.8e-07)", True),
    ("06_distributed_amg.py", "P=2 sharded  : 11 iterations (relres 5.0e-07)",
     "P=2 sharded  : 9 iterations (relres 1.8e-07)", False),
    ("06_distributed_amg.py", "P=2 sharded  : 9 iterations (relres 1.1e-06)",
     "P=2 sharded  : 9 iterations (relres 1.8e-07)", False),
    ("02_multi_device.py", "(a) halo-exchange CG: 19 iterations, relres 1.61e-12",
     "(a) halo-exchange CG: 19 iterations, relres 1.60e-12", True),
    ("02_multi_device.py", "(a) halo-exchange CG: 19 iterations, relres 1.62e-12",
     "(a) halo-exchange CG: 19 iterations, relres 1.60e-12", False),
    ("03_amg_and_mixed_precision.py",
     "relres 2.29e-11 in 2 sweeps / 119 inner iterations",
     "relres 2.52e-11 in 2 sweeps / 117 inner iterations", True),
    ("03_amg_and_mixed_precision.py",
     "relres 2.29e-11 in 2 sweeps / 120 inner iterations",
     "relres 2.52e-11 in 2 sweeps / 117 inner iterations", False),
    ("03_amg_and_mixed_precision.py",
     "relres 2.29e-11 in 3 sweeps / 117 inner iterations",
     "relres 2.52e-11 in 2 sweeps / 117 inner iterations", False),
    ("05_fem_flux_bcs.py", "Neumann: CG+AMG 12 iterations, max |u| = 2.0e-09",
     "Neumann: CG+AMG 12 iterations, max |u| = 1.0e-13", False),
    ("04_transient.py", "spectrum: [0.193, 21.995]",
     "spectrum: [0.192, 21.995]", False),
])
def test_the_rule_holds_each_kind_of_number(script, got, ref, ok):
    assert (chip_smoke.example_mismatches(script, got, ref) == []) is ok
