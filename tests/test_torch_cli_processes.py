"""The drivers' ``--partitions`` routes across processes: the port's
``cli/solve.py`` and ``cli/matrix_test.py`` run by two processes over gloo
on the CPU, as a launcher starts them (the ``DDPS_*`` variables, one spawn
of :mod:`test_torch_multiproc_worker` for the module; torchrun once),
against the one-process port CLI and the JAX package's CLI on 4 of its 8
virtual devices.

- Every run exits alike on both processes; process 0 alone prints and
  writes the solution file and the ``--output-prefix`` dumps, and they
  equal the one-process run's bit for bit.
- The "Converged in N iterations" lines equal JAX's in f64 (f32: within
  one iteration, as ``test_torch_parallel_cli.py`` holds); the matrix
  test's final line is the one-process line and its iterations JAX's.
- A part count the processes do not divide exits 2 on both with one
  message, a partition that differs between them raises on both, a
  process that cannot read its input stops both (exit 1), and an
  exception in one process ends the other at its next collective.
"""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.cli.matrix_test import main as j_power
from domain_decomposed_pde_solver_tpu.cli.solve import main as j_main
from domain_decomposed_pde_solver_tpu_torch.cli.matrix_test import (
    main as p_power,
)
from domain_decomposed_pde_solver_tpu_torch.cli.solve import main as p_main
from domain_decomposed_pde_solver_tpu_torch.io import (
    box_mesh,
    read_nodal_vars,
    refine_uniform,
    write_exodus,
)
from domain_decomposed_pde_solver_tpu_torch.parallel import multihost
from test_torch_multiproc_worker import spawn

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
_CONVERGED = re.compile(r"^(Converged|DID NOT converge) in (\d+) iterations",
                        re.M)
_LAMBDA = re.compile(r"^lambda_max ~= .* after (\d+) iterations.*$", re.M)
F64 = ["--dtype", "float64", "--tolerance", "1e-10", "--iterations", "600"]
SLAB = ["--precond", "amg", "--dtype", "float64", "--tolerance", "1e-8"]

# name: (mesh, argv after --input/--solution, the port's preconditioner)
SOLVES = {
    "cg-jacobi": ("refined", ["--partitions", "4", "--precond", "jacobi",
                              "--no-snapshots"] + F64, "NoneType"),
    "cg-jacobi-snapshots": ("refined", ["--partitions", "4", "--precond",
                                        "jacobi", "--reportAfterIterations",
                                        "9"] + F64, "NoneType"),
    "gmres": ("refined", ["--partitions", "4", "--solver", "gmres",
                          "--precond", "jacobi", "--no-snapshots"] + F64,
              "NoneType"),
    "cg-amg": ("refined", ["--partitions", "4", "--precond", "amg",
                           "--no-snapshots"] + F64, "HaloAMG"),
    "f32-jacobi": ("refined", ["--partitions", "4", "--precond", "jacobi",
                               "--no-snapshots", "--dtype", "float32",
                               "--tolerance", "1e-5"], "NoneType"),
    "output-prefix": ("refined", ["--partitions", "4", "--precond", "jacobi",
                                  "--no-snapshots", "--outputPrefix",
                                  "{dir}/dump{rank}-"] + F64, "NoneType"),
    "slab-refine": ("tall", ["--partitions", "4", "--no-snapshots"] + SLAB,
                    "SlabPadAMG"),
    "slab-refine-snapshots": ("tall", ["--partitions", "4"] + SLAB,
                              "SlabPadAMG"),
    "slab-dia": ("box", ["--partitions", "4", "--no-snapshots"] + SLAB,
                 "SlabAMG"),
}
POWER = ["--partitions", "4", "--iterations", "200", "--reportFrequency",
         "20", "--tolerance", "1e-6"]
MESHES = {
    "refined": lambda: refine_uniform(box_mesh(6, 6, 6, "TETRA4"), 1),
    "tall": lambda: box_mesh(8, 6, 92, "TETRA4"),  # free 7 x 7 x 93: pad P4
    "box": lambda: box_mesh(8, 6, 30, "TETRA4"),  # free 7 x 7 x 31: DIA P4
}


def _solve_argv(name: str, where) -> list:
    mesh, argv, _kind = SOLVES[name]
    return ["--input", str(where / f"{mesh}.exo"), "--solution",
            str(where / f"{name}.{{rank}}.exo")] + [
        a.replace("{dir}", str(where)) for a in argv] + ["--cpu"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    where = tmp_path_factory.mktemp("cli_processes")
    for name, make in MESHES.items():
        write_exodus(str(where / f"{name}.exo"), make())
    shutil.copy(where / "refined.exo", where / "in0.exo")  # no in1.exo
    return where


@pytest.fixture(scope="module")
def runs(files):
    """Both processes' record of every run (the failing ones last)."""
    routes = {name: ["solve", *_solve_argv(name, files)] for name in SOLVES}
    routes["power"] = ["matrix_test", "--input", str(files / "refined.exo"),
                       "--cpu", *POWER]
    refined = str(files / "refined.exo")
    for name, mesh, parts in (("indivisible", refined, "3"),
                              ("mismatch", refined, "4"),
                              ("unreadable", str(files / "in{rank}.exo"),
                               "4"),
                              ("raise", refined, "4")):
        routes[name] = ["solve", "--input", mesh, "--solution",
                        str(files / "failed.{rank}.exo"), "--cpu",
                        "--partitions", parts] + F64
    path = files / "routes.json"
    path.write_text(json.dumps(routes))
    recs = spawn("cli", files, path)
    return [{k: v.item() if v.ndim == 0 else v for k, v in r.items()}
            for r in recs]


@pytest.fixture(scope="module")
def one_process(files):
    """The one-process port CLI's run of a route, once: its report, output
    and file."""
    done = {}

    def run(name: str, capsys) -> tuple:
        if name not in done:
            argv = [a.replace("{rank}", "one")
                    for a in _solve_argv(name, files)]
            rep = {}
            capsys.readouterr()
            assert p_main(argv, report=rep) == 0
            done[name] = (rep, capsys.readouterr().out,
                          files / f"{name}.one.exo")
        return done[name]

    return run


def _iterations(text: str) -> int:
    m = _CONVERGED.search(text)
    assert m is not None, text
    return int(m.group(2))


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_two_processes_write_one_process_file(runs, files, one_process,
                                             capsys, name):
    r0, r1 = runs
    for r in runs:
        assert (r[f"{name}_rc"], r[f"{name}_error"]) == (0, ""), \
            r[f"{name}_stderr"]
        assert r[f"{name}_precond"] == SOLVES[name][2]
    assert r1[f"{name}_stdout"] == ""  # process 0 alone prints
    assert not (files / f"{name}.1.exo").exists()
    rep, text, one = one_process(name, capsys)
    assert _iterations(r0[f"{name}_stdout"]) == _iterations(text)
    assert type(rep["precond"]).__name__ == SOLVES[name][2]
    _n0, t0, v0 = read_nodal_vars(str(files / f"{name}.0.exo"))
    _n1, t1, v1 = read_nodal_vars(str(one))
    np.testing.assert_array_equal(t0, t1)
    np.testing.assert_array_equal(v0, v1)


def test_process_zero_alone_writes_the_dumps(runs, files, one_process,
                                            capsys):
    one_process("output-prefix", capsys)
    ours = sorted(files.glob("dump0-*"))
    assert ours and not list(files.glob("dump1-*"))
    for f in ours:
        twin = files / f.name.replace("dump0-", "dumpone-")
        assert f.read_bytes() == twin.read_bytes(), f.name


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_two_processes_take_jax_iterations(runs, files, capsys, name):
    argv = [a.replace("{rank}", "jax") for a in _solve_argv(name, files)]
    if "--outputPrefix" in argv:  # the numbers only
        i = argv.index("--outputPrefix")
        del argv[i: i + 2]
    capsys.readouterr()
    assert j_main(argv + ["--x64"]) == 0
    theirs = _iterations(capsys.readouterr().out)
    ours = _iterations(runs[0][f"{name}_stdout"])
    if "float32" in argv:
        assert abs(ours - theirs) <= 1
    else:
        assert ours == theirs


def test_matrix_test_over_two_processes(runs, files, capsys):
    r0, r1 = runs
    assert r0["power_rc"] == r1["power_rc"] == 0
    assert r1["power_stdout"] == ""
    ours = _LAMBDA.search(r0["power_stdout"])
    assert p_power(["--input", str(files / "refined.exo"), "--cpu"]
                   + POWER) == 0
    one = _LAMBDA.search(capsys.readouterr().out)
    assert j_power(["--input", str(files / "refined.exo"), "--cpu"]
                   + POWER) == 0
    theirs = _LAMBDA.search(capsys.readouterr().out)
    assert ours.group(0) == one.group(0)
    assert ours.group(1) == theirs.group(1)


def test_indivisible_parts_exit_on_both_with_one_message(runs):
    for r in runs:
        assert r["indivisible_rc"] == 2 and r["indivisible_stdout"] == ""
        assert r["indivisible_s"] < 5.0
    lines = {r["indivisible_stderr"] for r in runs}
    assert len(lines) == 1
    (line,) = lines
    assert line.count("\n") == 1
    assert "--partitions 3 is not a multiple of the 2 processes" in line


def test_a_partition_that_differs_raises_on_both(runs):
    for r in runs:
        assert r["mismatch_error"].startswith(
            "ValueError: the partition differs between the processes"), \
            r["mismatch_error"]


def test_one_process_that_cannot_read_stops_both(runs):
    for r in runs:
        assert r["unreadable_rc"] == 1 and r["unreadable_error"] == ""
    assert "in1.exo" in runs[1]["unreadable_stderr"]


def test_an_exception_in_one_process_ends_the_other(runs):
    assert runs[1]["raise_error"] == "RuntimeError: a failure in process 1"
    assert runs[0]["raise_error"].startswith("RuntimeError")
    assert max(r["raise_s"] for r in runs) < 60.0


def test_torchrun_runs_the_module_across_processes(files, one_process,
                                                  capsys):
    """``torchrun --standalone --nproc-per-node 2 -m ...cli.solve``: the
    launcher's variables, a TCP rendezvous on this host."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO),
                                           os.environ.get("PYTHONPATH", "")]))
    argv = [a.replace("{rank}", "torchrun")
            for a in _solve_argv("cg-amg", files)]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m",
         "domain_decomposed_pde_solver_tpu_torch.cli.solve", *argv],
        capture_output=True, text=True, timeout=180, env=env, cwd=files)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(_CONVERGED.findall(proc.stdout)) == 1, proc.stdout
    _rep, _text, one = one_process("cg-amg", capsys)
    np.testing.assert_array_equal(
        read_nodal_vars(str(files / "cg-amg.torchrun.exo"))[2],
        read_nodal_vars(str(one))[2])


@pytest.mark.parametrize("env, want", [
    ({}, None),
    ({"WORLD_SIZE": "1", "RANK": "0"}, None),
    ({"WORLD_SIZE": "4", "RANK": "3", "MASTER_ADDR": "localhost",
      "MASTER_PORT": "29400"}, ("localhost:29400", 4, 3)),
    ({"DDPS_COORDINATOR": "file:///tmp/r", "DDPS_NUM_PROCESSES": "2",
      "DDPS_PROCESS_ID": "1", "WORLD_SIZE": "4", "RANK": "3"},
     ("file:///tmp/r", 2, 1)),
])
def test_launcher_settings(monkeypatch, env, want):
    for key in ("DDPS_COORDINATOR", "DDPS_NUM_PROCESSES", "DDPS_PROCESS_ID",
                "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert multihost.launcher_settings() == want
    refusal = multihost.launch_refusal(6)
    assert (refusal is not None) == (want is not None and 6 % want[1] != 0)


def test_launcher_settings_name_what_is_missing(monkeypatch):
    monkeypatch.delenv("DDPS_NUM_PROCESSES", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR, MASTER_PORT"):
        multihost.launcher_settings()
