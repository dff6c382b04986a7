"""The distributed assembly (``parallel/distassembly.py``): the port
against the JAX package.

- ``assemble_heat_distributed`` (the P-rank pipeline in one process)
  gives JAX's plan arrays and right-hand side bit for bit, and the slices
  of ``build_halo_plan`` on the global system, on JAX's test cases with
  boxes in place of the absent ``tet-cube-heat.exo``: (ranks, parts) in
  {(2, 2), (2, 4), (4, 4), (3, 3)}, the HEX8 6 x 5 x 4 box at (4, 8) and
  the TETRA4 4 x 4 x 3 box at (2, 8).
- ``dist_local_phase`` gives JAX's state, field by field.
- Two processes over gloo (``tests/test_torch_multiproc_worker.py``, one spawn
  for the module) run ``assemble_heat_multihost``: each holds JAX's
  blocks of its parts, one sharded product agrees with scipy to 1e-12,
  and f64 Jacobi ``sharded_cg_solve`` stops within one iteration of
  JAX's single-process ``sharded_cg_solve`` on the same plan (8 virtual
  devices, ``tests/conftest.py``).
"""

import dataclasses

import numpy as np
import pytest

from domain_decomposed_pde_solver_tpu.io.boxmesh import box_mesh as jax_box
from domain_decomposed_pde_solver_tpu.io.exodus import write_exodus
from domain_decomposed_pde_solver_tpu.parallel import (
    distassembly as jax_dist,
)
from domain_decomposed_pde_solver_tpu_torch.io import read_exodus
from domain_decomposed_pde_solver_tpu_torch.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu_torch.parallel import build_halo_plan
from domain_decomposed_pde_solver_tpu_torch.parallel import (
    distassembly as port_dist,
)
from test_torch_multiproc_worker import spawn

PLAN_ARRAYS = ("perm", "part_of_row", "local_of_row", "ell_cols", "ell_vals",
               "send_idx", "row_valid")


def _box(tmp_path, nx, ny, nz, elem_type):
    path = str(tmp_path / f"box_{nx}{ny}{nz}_{elem_type}.exo")
    write_exodus(path, jax_box(nx, ny, nz, elem_type=elem_type))
    return path


def _assert_plans_equal(a, b):
    assert (a.nparts, a.n_global, a.n_local, a.halo_width) == (
        b.nparts, b.n_global, b.n_local, b.halo_width)
    for name in PLAN_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


CASES = [(2, 2, (9, 8, 7, "TETRA4")), (2, 4, (9, 8, 7, "TETRA4")),
         (4, 4, (9, 8, 7, "TETRA4")), (3, 3, (9, 8, 7, "TETRA4")),
         (4, 8, (6, 5, 4, "HEX8")), (2, 8, (4, 4, 3, "TETRA4"))]


@pytest.mark.parametrize("nranks,nparts,box", CASES)
def test_distributed_plan_matches_jax(tmp_path, nranks, nparts, box):
    path = _box(tmp_path, *box)
    plan_j, b_j, _ = jax_dist.assemble_heat_distributed(path, nranks, nparts)
    plan_t, b_t, state = port_dist.assemble_heat_distributed(
        path, nranks, nparts)
    _assert_plans_equal(plan_t, plan_j)
    np.testing.assert_array_equal(b_t, b_j)
    # ... and the global halo plan's slices on the same partition.
    sy = assemble_heat_system(read_exodus(path))
    _assert_plans_equal(plan_t, build_halo_plan(sy.A, state.owner_free,
                                                nparts))
    np.testing.assert_array_equal(b_t, sy.b)


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_local_phase_state_matches_jax(tmp_path, rank):
    path = _box(tmp_path, 9, 8, 7, "TETRA4")
    sj = jax_dist.dist_local_phase(path, rank, 3, 6)
    st = port_dist.dist_local_phase(path, rank, 3, 6)
    for f in dataclasses.fields(port_dist.DistLocalState):
        a, b = getattr(st, f.name), getattr(sj, f.name)
        if f.name == "send_keys":
            assert len(a) == len(b) == 3
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f.name)


def test_single_process_multihost_is_the_pipeline(tmp_path):
    """One process: ``assemble_heat_multihost`` holds every part and its
    operator is the one-process ``ShardedOperator``."""
    path = _box(tmp_path, 6, 5, 4, "HEX8")
    op, b_s, plan, state = port_dist.assemble_heat_multihost(
        path, nparts=4, device="cpu")
    plan_d, b_d, _ = port_dist.assemble_heat_distributed(path, 1, 4)
    _assert_plans_equal(plan, plan_d)
    assert type(op).__name__ == "ShardedOperator"
    np.testing.assert_array_equal(op.get_vector(b_s), b_d)


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    out = tmp_path_factory.mktemp("distassembly")
    path = _box(out, 10, 8, 6, "HEX8")
    ranks = spawn("distassembly", out, path, 4)
    return path, ranks


def test_two_processes_hold_jax_blocks(two_process):
    path, ranks = two_process
    plan_j, b_j, _ = jax_dist.assemble_heat_distributed(path, 2, 4)
    for r, got in enumerate(ranks):
        assert (int(got["world"]), int(got["local_parts"])) == (2, 2)
        assert str(got["kind"]) == "ShardedOperator"
        assert (int(got["n_local"]), int(got["H"])) == (
            plan_j.n_local, plan_j.halo_width)
        cut = slice(2 * r, 2 * r + 2)
        for name in ("ell_cols", "ell_vals", "send_idx", "row_valid"):
            np.testing.assert_array_equal(got[name],
                                          getattr(plan_j, name)[cut])
        np.testing.assert_array_equal(got["b_local"], plan_j.scatter_vector(
            b_j)[cut])
        np.testing.assert_array_equal(got["b"], b_j)


def test_two_process_product_matches_scipy(two_process):
    path, ranks = two_process
    sy = assemble_heat_system(read_exodus(path))
    x = np.random.default_rng(7).standard_normal(sy.A.n_rows)
    y = sy.A.to_scipy() @ x
    for got in ranks:
        np.testing.assert_allclose(got["y"], y, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ranks[0]["y"], ranks[1]["y"])


def test_two_process_cg_matches_jax_single_process(two_process):
    from domain_decomposed_pde_solver_tpu.parallel.sharded import (
        ShardedOperator,
        make_device_mesh,
        sharded_cg_solve,
    )

    path, ranks = two_process
    plan, b, _ = jax_dist.assemble_heat_distributed(path, 2, 4)
    op = ShardedOperator.from_plan(plan, make_device_mesh(4))
    slot = np.argmax(plan.ell_cols == np.arange(
        plan.n_local, dtype=np.int32)[None, :, None], axis=2)
    diag = plan.gather_vector(np.take_along_axis(
        plan.ell_vals, slot[..., None], axis=2)[..., 0])
    res = sharded_cg_solve(op, op.put_vector(b), op.put_vector(
        np.zeros_like(b)), precond_diag=op.put_vector(1.0 / diag), tol=1e-10,
        maxiter=2000)
    x_j = np.asarray(op.get_vector(res.x))
    assert int(ranks[0]["iterations"]) == int(ranks[1]["iterations"])
    assert abs(int(ranks[0]["iterations"]) - int(res.iterations)) <= 1
    np.testing.assert_array_equal(ranks[0]["x"], ranks[1]["x"])
    assert np.linalg.norm(ranks[0]["x"] - x_j) <= 1e-8 * np.linalg.norm(x_j)
