"""Phase J of ``chip_smoke.py`` (the multi-process decomposition) on the
CPU at small sizes: two worker processes over gloo, as on the card, on a
HEX8 6^3 box (J1, J2: 245 rows over 4 parts) and a TETRA4 8^3 box (J3:
567 DOF over 4 slabs), held to the one-process runs of the parent.

The smoke's own checks run as on the card (the launch counts and the
CUDA-event times are the card's only): the same iterations in both
processes and within the limits of one process's, rank 0's blocks
bit-identical to the global plan's, the same full answer in both
processes, the checkpoint reassembled bit for bit.  On the CPU every
product runs its plain version, so the kernel comparisons agree exactly.
Also: JAX's single-process ``multihost_slab_cg_solve`` on J3's system
takes the workers' count within max(2, 2 %), and a worker that fails
fails the phase.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from domain_decomposed_pde_solver_tpu.io.boxmesh import box_mesh as jax_box
from domain_decomposed_pde_solver_tpu.models import (
    assemble_heat_system as jax_assemble,
)
from domain_decomposed_pde_solver_tpu.parallel.multihost import (
    multihost_slab_cg_solve,
)
from domain_decomposed_pde_solver_tpu.parallel.slab import build_slab_plan

CFG = dict(hex_box=6, tet_box=8, hex_dof=5 * 7 * 7, tet_dof=7 * 9 * 9,
           device="cpu")


@pytest.fixture(scope="module")
def run_j(tmp_path_factory):
    out = tmp_path_factory.mktemp("phase_j")
    return chip_smoke.phase_j(torch.device("cpu"), cfg=CFG, out=out), out


def test_phase_j_passes_its_checks_on_the_cpu(run_j):
    run, _out = run_j
    json.dumps(run)  # what the smoke's record line prints of it
    w, one = run["workers"], run["one_process"]
    assert [r["rank"] for r in w] == [0, 1]
    for r in w:
        assert (r["world"], r["backend"], r["staged"]) == (2, "gloo", False)
        assert r["J1"]["n_free"] == CFG["hex_dof"]
        assert r["J1"]["operator"] == "ShardedOperator"
        assert r["J1"]["local_parts"] == r["J2"]["parts"] == 2
        assert r["J2"]["storage"] == one["J2"]["storage"] == "bfloat16"
        for tag in ("J1", "J2", "J3"):
            assert r[tag]["iterations"] == one[tag]["iterations"]
        assert r["peak_rss_mb"] > 0
        assert set(r["collectives_ms"]) == {"psum_dot", "halo_exchange",
                                            "neighbour_strips"}
    assert w[0]["J1"]["bit_identical"] is True
    assert w[0]["J1"]["host_relres"] <= 1.5e-8
    assert w[0]["J1"]["product_relerr"] <= 1e-12
    assert run["checkpoint_rows"] == [0, 1, 2, 3]
    assert run["errs"] == {"sell_spmv": 0.0}
    assert run["j3_relerr"] <= 1e-5


def test_phase_j_launches_name_each_worker(run_j):
    run, _out = run_j
    launches = chip_smoke.phase_j_launches(run, "sell_spmv")
    assert launches == {"J2 rank 0": 0, "J2 rank 1": 0}  # plain on the CPU


def test_phase_j_slab_cg_matches_jax(run_j):
    run, out = run_j
    n = CFG["tet_box"]
    sy = jax_assemble(jax_box(n, n, n, elem_type="TETRA4"))
    plan = build_slab_plan(sy.A, nparts=4)
    b = (sy.b / np.abs(sy.b).max()).astype(np.float32)
    x, res = multihost_slab_cg_solve(plan, b, np.zeros_like(b), tol=1e-6,
                                     maxiter=20000)
    its = run["workers"][0]["J3"]["iterations"]
    assert chip_smoke._within(its, int(res.iterations))
    x_w = np.load(out / "j3_x.rank0.npy")
    x = np.asarray(x)
    assert np.linalg.norm(x_w - x) <= 1e-5 * np.linalg.norm(x)


def test_a_failing_worker_fails_the_phase(tmp_path):
    with pytest.raises(chip_smoke.SmokeFailure, match="worker"):
        chip_smoke.phase_j(torch.device("cpu"),
                           cfg={**CFG, "hex_dof": CFG["hex_dof"] + 1},
                           out=tmp_path)


@pytest.mark.parametrize("a,b,ok", [(100, 102, True), (100, 103, False),
                                    (500, 510, True), (500, 511, False)])
def test_within_is_max_of_2_and_2_percent(a, b, ok):
    assert chip_smoke._within(a, b) is ok
