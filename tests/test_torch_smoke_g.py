"""Phase G of ``chip_smoke.py`` (the BASELINE's 10M box through the
scan-free structured route) on the CPU at ``box_mesh(26, 26, 26)``'s size,
held to the JAX package's route (``bench10m.py``) at the same size.

The smoke's own checks run as on the card (the kernel-launch checks are
the card's only): the device-built b and degree, convergence, the host
f64 relres <= 1.5e-8 of the refined answer, 2-3 refinement sweeps, values
within [100, 1000], a pad-stencil level 0 with brick transfers and DIA
levels below it.  Beside them: the sweeps equal JAX's, the inner
iterations within one per sweep and CG+AMG's within one (f32 rounding),
the answers within 1e-6 relative.  On the CPU every wrapper runs its
plain version, so the kernel comparisons agree exactly.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
from torch_parity import jax_box10m_route, relerr

torch.set_num_threads(1)

N = 26  # free grid 25 x 27 x 27: 18,225 DOF


@pytest.fixture(scope="module")
def run_g():
    return chip_smoke.phase_g(torch.device("cpu"), _kernels.KERNELS, n=N)


def test_phase_g_passes_its_checks_on_the_cpu(run_g):
    rec = chip_smoke.phase_g_record(run_g)
    json.dumps(rec)  # what the smoke's record line prints of it
    assert rec["dof"] == (N - 1) * (N + 1) ** 2
    assert [lvl["operator"] for lvl in rec["levels"]] == [
        "PadStencilOperator", "DIAMatrix"]
    assert rec["levels"][0]["transfer"] == "PadBrickProlongator"
    assert rec["host_relres"] <= 1.5e-8
    assert set(rec["times"]) >= {"assembly_s", "parts_s", "operator_s",
                                 "amg_setup_s", "amg_setup_phases_s",
                                 "cg_ms", "refine_ms"}
    assert set(run_g["replays"]) == {"G cg", "G refine"}
    errs = chip_smoke.compare_phase_g(torch.device("cpu"), run_g)
    assert errs == {"pad_stencil": 0.0, "dia_spmv": 0.0}


def test_phase_g_takes_the_jax_route(run_g):
    _sy, jM, jr, jmr = jax_box10m_route(N)
    M, r, mr = run_g["M"], run_g["cg"], run_g["refine"]
    assert [lvl.n_rows for lvl in M.levels] == [lvl.n_rows
                                                for lvl in jM.levels]
    assert abs(r.iterations - int(jr.iterations)) <= 1
    assert mr.refinements == jmr.refinements
    assert abs(mr.inner_iterations - jmr.inner_iterations) <= jmr.refinements
    assert relerr(mr.x, jmr.x) <= 1e-6
    # A replay repeats the counted solve.
    again = run_g["replays"]["G refine"][0]()
    assert again.refinements == mr.refinements
    np.testing.assert_array_equal(again.x, mr.x)
