"""The multi-process route (``parallel/multihost.py``) and the last two
host utilities: the port against the JAX package.

- Two processes over gloo (``tests/test_torch_multiproc_worker.py``, one spawn
  for the module) run ``multihost_slab_cg_solve`` in f64 to 1e-10: JAX's
  single-process ``multihost_slab_cg_solve`` over 4 of the 8 virtual
  devices takes the same iterations, and the answers agree to 1e-10
  relative; each process holds its two slabs; both return the same full
  answer.
- The one-controller entry points over the process mesh give, bit for
  bit, what the same call gives over a mesh of one process, which stays
  one-process inside the process group (and equals JAX's): over a
  ``ShardedOperator`` the halo AMG CG, block-Schwarz AMG CG, two-level
  Schwarz CG and block-ILUT GMRES; ``slab_cg_solve`` with Jacobi and with
  the brick preconditioner (with and without its slab-mean correction),
  ``slab_stencil_cg_solve``, the slab global AMG in f64 and f32, slab-pad
  Jacobi CG, slab-pad AMG CG and its f64 refinement.  A collective and a
  per-part preconditioner refuse a tensor of all the parts, and a
  hierarchy refuses a mesh it was not built over.
- Sharded checkpoints: each process writes its parts (JAX's keys, one
  part per ``name__row``), whole arrays from process 0 only; the port
  reads a file JAX wrote, and JAX reads the port's.
- ``make_device_mesh``: one process as before, a part count the
  processes do not divide raises ``ValueError``, two devices in one
  process ``NotImplementedError``.
- ``initialize_multihost`` reads the ``DDPS_*`` variables; the backend
  rule (gloo on a shared card or the CPU, NCCL with a card per process).
- ``trace_to`` and ``enable_malloc_reuse``.
"""

import json
import re

import numpy as np
import pytest
import torch

import domain_decomposed_pde_solver_tpu_torch.utils.hostmem as hostmem
from domain_decomposed_pde_solver_tpu.io.boxmesh import box_mesh as jax_box
from domain_decomposed_pde_solver_tpu.models import (
    assemble_heat_system as jax_assemble,
)
from domain_decomposed_pde_solver_tpu.parallel import multihost as jax_mh
from domain_decomposed_pde_solver_tpu.parallel.slab import (
    build_slab_plan as jax_slab_plan,
)
from domain_decomposed_pde_solver_tpu_torch.parallel import (
    make_device_mesh,
    multihost as port_mh,
)
from domain_decomposed_pde_solver_tpu_torch.parallel.sharded import DeviceMesh
from domain_decomposed_pde_solver_tpu_torch.utils import (
    enable_malloc_reuse,
    trace_to,
)
from test_torch_multiproc_worker import spawn

BOX = (6, 6, 12)


@pytest.fixture(scope="module")
def slab_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("slabcg")
    return spawn("slabcg", out, *BOX, 4)


@pytest.fixture(scope="module")
def jax_slab():
    sy = jax_assemble(jax_box(*BOX, elem_type="TETRA4"))
    plan = jax_slab_plan(sy.A, nparts=4, dtype=np.float64)
    x, res = jax_mh.multihost_slab_cg_solve(
        plan, sy.b, np.zeros_like(sy.b), tol=1e-10, maxiter=2000)
    return plan, np.asarray(x), res


def test_two_process_slab_cg_matches_jax(slab_run, jax_slab):
    plan, x_j, res_j = jax_slab
    for got in slab_run:
        assert int(got["iterations"]) == int(res_j.iterations)
        assert np.linalg.norm(got["x"] - x_j) <= 1e-10 * np.linalg.norm(x_j)
        assert float(got["relres"]) <= 1e-10
    np.testing.assert_array_equal(slab_run[0]["x"], slab_run[1]["x"])


def test_each_process_holds_its_slabs(slab_run, jax_slab):
    plan, _x, res_j = jax_slab
    full = np.asarray(res_j.x)
    for r, got in enumerate(slab_run):
        assert (int(got["mesh_lo"]), int(got["mesh_k"])) == (2 * r, 2)
        assert got["local"].shape == (2, plan.slab)
        np.testing.assert_allclose(got["local"], full[2 * r: 2 * r + 2],
                                   rtol=0, atol=1e-10 * np.abs(full).max())


@pytest.mark.parametrize("route", [
    "halo_amg", "block_amg", "two_level", "block_ilut", "slab", "brick",
    "brick_global", "stencil", "slab_amg_f64", "slab_amg_f32", "slab_pad",
    "slab_pad_amg", "slab_pad_refine"])
def test_entry_points_across_processes_equal_one_process(slab_run, route):
    for got in slab_run:
        assert int(got[f"{route}_proc_it"]) == int(got[f"{route}_one_it"])
        np.testing.assert_array_equal(got[f"{route}_proc_x"],
                                      got[f"{route}_one_x"])
    np.testing.assert_array_equal(slab_run[0][f"{route}_proc_x"],
                                  slab_run[1][f"{route}_proc_x"])
    if route == "stencil":
        assert [tuple(g["stencil_proc_shape"]) for g in slab_run] == [
            (2, 288), (2, 288)]
        assert tuple(slab_run[0]["stencil_one_shape"]) == (4, 288)
    if route == "block_amg":
        assert [int(g["block_amg_proc_parts"]) for g in slab_run] == [2, 2]
        assert int(slab_run[0]["block_amg_one_parts"]) == 4


def test_one_process_mesh_in_a_process_group_is_one_process(slab_run,
                                                            jax_slab):
    _plan, x_j, res_j = jax_slab
    for got in slab_run:
        assert int(got["slab_one_it"]) == int(res_j.iterations)
        assert np.linalg.norm(got["slab_one_x"] - x_j) <= \
            1e-10 * np.linalg.norm(x_j)


@pytest.mark.parametrize("what,match", [
    ("whole_block", "ValueError: a residual of 2 parts for 4 part"),
    ("other_mesh", r"ValueError: mesh of 4 parts on cpu \(process [01] of 2\) "
                   r"for a plan of 4 parts on cpu \(process 0 of 1\)"),
    ("all_parts", "ValueError: 4 parts on a process holding 2"),
])
def test_process_mesh_refusals(slab_run, what, match):
    for got in slab_run:
        assert re.match(match, str(got[f"refuse_{what}"]))


def test_sharded_checkpoint_round_trip(slab_run):
    for r, got in enumerate(slab_run):
        assert list(got["rows"]) == [2 * r, 2 * r + 1]
        np.testing.assert_array_equal(got["back"], got["local"])
    assert [bool(g["has_b"]) for g in slab_run] == [True, False]


def test_port_and_jax_read_each_others_checkpoints(tmp_path):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    x = np.arange(4 * 6, dtype=np.float64).reshape(4, 6)
    meta = np.array([3, 1, 4])
    sh = NamedSharding(Mesh(np.array(jax.devices()[:4]), ("p",)), P("p"))
    jax_mh.save_sharded_checkpoint(str(tmp_path / "j"), {
        "x": jax.device_put(x, sh), "meta": meta})
    port_mh.save_sharded_checkpoint(str(tmp_path / "t"), {
        "x": torch.from_numpy(x), "meta": meta})
    for prefix in ("j", "t"):
        for load in (port_mh.load_sharded_checkpoint,
                     jax_mh.load_sharded_checkpoint):
            back = load(str(tmp_path / prefix))
            assert sorted(back["x"]) == [0, 1, 2, 3]
            for row, blk in back["x"].items():
                np.testing.assert_array_equal(blk, x[row: row + 1])
            np.testing.assert_array_equal(back["meta"], meta)
    with np.load(tmp_path / "j.proc0.npz") as zj, \
            np.load(tmp_path / "t.proc0.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)


def test_make_device_mesh_one_process_as_before():
    m = make_device_mesh(8, ["cpu"])
    assert m == DeviceMesh(8, torch.device("cpu"))
    assert (m.rank, m.world, m.local_parts, m.parts_lo) == (0, 1, 8, 0)
    assert make_device_mesh(3, ["cpu"]).local_parts == 3
    with pytest.raises(NotImplementedError, match="initialize_multihost"):
        make_device_mesh(2, ["cpu", "cuda:0"])


def test_make_device_mesh_refuses_parts_the_processes_do_not_divide(
        slab_run):
    for got in slab_run:
        assert str(got["indivisible"]) == "nparts=3 not divisible by 2 " \
                                          "processes"


def test_initialize_multihost_reads_the_ddps_variables(tmp_path,
                                                      monkeypatch):
    import torch.distributed as dist

    for name in ("DDPS_COORDINATOR", "DDPS_NUM_PROCESSES",
                 "DDPS_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="DDPS_COORDINATOR"):
        port_mh.initialize_multihost(device="cpu")
    monkeypatch.setenv("DDPS_COORDINATOR", f"file://{tmp_path / 'rv'}")
    monkeypatch.setenv("DDPS_NUM_PROCESSES", "1")
    monkeypatch.setenv("DDPS_PROCESS_ID", "0")
    try:
        assert port_mh.initialize_multihost(device="cpu", timeout_s=60) == 0
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        # One process in the group: every path is the one-process path.
        assert make_device_mesh(4, ["cpu"]) == DeviceMesh(
            4, torch.device("cpu"))
    finally:
        dist.destroy_process_group()


def test_backend_rule(monkeypatch):
    assert port_mh.choose_backend(2, device="cpu") == "gloo"
    with pytest.raises(ValueError, match="nccl"):
        port_mh.choose_backend(2, "nccl", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert port_mh.choose_backend(2) == "gloo"  # two processes, one card
    with pytest.raises(ValueError, match="1 card"):
        port_mh.choose_backend(2, "nccl")
    assert port_mh.choose_backend(1) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert port_mh.choose_backend(4) == "nccl"
    assert port_mh.choose_backend(4, "gloo") == "gloo"
    assert port_mh.choose_backend(8) == "gloo"  # eight processes, four cards
    with pytest.raises(ValueError, match="unknown"):
        port_mh.choose_backend(4, "mpi")


def test_backend_and_card_follow_the_processes_on_this_host(monkeypatch):
    """The backend and the card are decided by the processes on this host
    (``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``, as torchrun sets them), not by
    the global count: one process per host across hosts runs NCCL."""
    import torch.distributed as dist

    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        collectives,
        sharded,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    # Two hosts with one card and one process each: NCCL, card 0.
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert port_mh.choose_backend(2) == "nccl"
    assert port_mh.choose_backend(2, "nccl") == "nccl"
    assert collectives.local_card(process_id=1) == 0
    seen = {}
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: seen.setdefault("card", i))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_backend", lambda: "nccl")
    assert port_mh.initialize_multihost("tcp://localhost:1", 2, 1) == 1
    assert seen["backend"] == "nccl" and seen["card"] == 0
    assert seen["world_size"] == 2 and seen["rank"] == 1
    monkeypatch.setattr(sharded, "process_world", lambda: 2)
    monkeypatch.setattr(sharded, "process_rank", lambda: 1)
    mesh = make_device_mesh(4)
    assert mesh == DeviceMesh(4, torch.device("cuda", 0), 1, 2)
    assert (mesh.parts_lo, mesh.local_parts) == (2, 2)
    # Four processes on a host of two cards: gloo, two per card.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert port_mh.choose_backend(8) == "gloo"
    assert collectives.local_card() == 1
    with pytest.raises(ValueError, match="4 local processes, 2 card"):
        port_mh.choose_backend(8, "nccl")
    # An explicit NCCL request on a shared card still raises.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="nccl"):
        port_mh.choose_backend(2, "nccl")
    # Without the variables every process is on this host, as before.
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert port_mh.choose_backend(2) == "gloo"
    assert collectives.local_processes(2, 1) == (1, 2)


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with trace_to(None):
        torch.ones(4).sum()
    with trace_to(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "tr").glob("trace.*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_enable_malloc_reuse(monkeypatch):
    assert enable_malloc_reuse() is True  # enabled at import, idempotent
    monkeypatch.setattr(hostmem, "_done", False)
    monkeypatch.setenv("DDPS_NO_MALLOC_TUNING", "1")
    assert enable_malloc_reuse() is False
    monkeypatch.delenv("DDPS_NO_MALLOC_TUNING")
    assert enable_malloc_reuse() is True
