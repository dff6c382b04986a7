"""Phase F of ``chip_smoke.py`` (this slice's paths: transient heat and
Lanczos, resumable CG, the matrix test, the FEM models, the host drivers)
on the CPU at small sizes, held to the JAX package on the same inputs.

The smoke's own checks run as on the card (the kernel-launch checks are
the card's only).  Beside them: the transient's CG iterations equal JAX's
and its Lanczos extremes agree with JAX's within 1e-8 relative; the matrix
test's eigenvalue agrees with JAX's driver within 1e-10 relative; the FEM
solves take JAX's CG+AMG iteration counts.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from domain_decomposed_pde_solver_tpu.io import read_exodus as j_read_exodus
from domain_decomposed_pde_solver_tpu.models import (
    assemble_full_laplacian as j_full_laplacian,
    assemble_heat_system as j_assemble,
    transient_heat_solve as j_transient,
)
from domain_decomposed_pde_solver_tpu.ops import (
    choose_operator as j_choose_operator,
    ell_from_csr as j_ell_from_csr,
    pad_vector as j_pad_vector,
)
from domain_decomposed_pde_solver_tpu.solvers import (
    lanczos_extremes as j_lanczos,
    power_method as j_power,
)
from domain_decomposed_pde_solver_tpu_torch.io import box_mesh, write_exodus
from domain_decomposed_pde_solver_tpu_torch.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu_torch.ops import _kernels

torch.set_num_threads(1)

BOX, SMALL, QUAD = 12, 12, 5


@pytest.fixture(scope="module")
def run_f(tmp_path_factory):
    out = tmp_path_factory.mktemp("smoke")
    exo = out / f"box{BOX}.exo"
    write_exodus(str(exo), box_mesh(BOX, BOX, BOX, "TETRA4"))
    from domain_decomposed_pde_solver_tpu_torch.io import read_exodus

    sy = assemble_heat_system(read_exodus(str(exo)))
    run = chip_smoke.phase_f(torch.device("cpu"), _kernels.KERNELS, sy, exo,
                             box=BOX, small_box=SMALL, quad_cells=QUAD,
                             out=out)
    return run, exo


def test_phase_f_passes_its_checks_on_the_cpu(run_f):
    run, _exo = run_f
    assert set(run) == {"F1", "F2", "F3", "F4", "F5", "F6", "wall_s",
                        "replays", "errs"}
    assert run["F2"]["bit_identical"]
    # F4's and F5's operators went through the kernel comparisons (on the
    # CPU the wrappers run their plain versions, so they agree exactly).
    assert run["errs"] == {"dia_spmv": 0.0, "sell_spmv": 0.0}
    assert abs(run["F3"]["eigenvalue"] - run["F3"]["host_eigenvalue"]) <= (
        1e-10 * run["F3"]["host_eigenvalue"])
    # What the smoke's record line prints of it.
    json.dumps({k: v for k, v in run.items() if k != "replays"})
    # Phase E profiles each counted solve again: every replay runs.
    assert set(run["replays"]) == {
        "F1 lanczos", "F1 transient", "F2 resumable", "F3 power",
        "F4 neumann", "F4 robin", "F5 p2", "F5 q2"}
    again = {k: fn() for k, (fn, _counts) in run["replays"].items()}
    assert again["F2 resumable"].iterations == run["F2"]["iterations"]
    assert again["F1 transient"].total_cg_iterations == run["F1"][
        "cg_iterations"]
    assert again["F5 q2"].iterations == run["F5"]["q2"]["iterations"]
    launches = chip_smoke.phase_f_launches(run, "dia_spmv")
    assert set(launches) >= {"F1 lanczos", "F1 transient", "F2 whole", "F3",
                             "F4 neumann", "F4 robin", "F5 p2", "F5 q2"}
    assert not any(launches.values())  # plain versions on the CPU


def test_transient_and_lanczos_match_jax(run_f):
    run, exo = run_f
    jsy = j_assemble(j_read_exodus(str(exo)))
    JA = j_choose_operator(jsy.A, dtype=jnp.float64)
    jres = j_transient(jsy, JA, dt=0.2, n_steps=40, tol=1e-10)
    assert run["F1"]["cg_iterations"] == jres.total_cg_iterations
    z0 = np.zeros(JA.n_pad)
    z0[: jsy.n_free] = np.random.default_rng(0).standard_normal(jsy.n_free)
    jl = j_lanczos(JA, jnp.asarray(z0), k=40)
    for key, ref in (("lmin", jl.lmin), ("lmax", jl.lmax)):
        assert abs(run["F1"][key] - float(ref)) <= 1e-8 * float(ref)


def test_matrix_test_matches_jax(run_f):
    run, exo = run_f
    L = j_full_laplacian(j_read_exodus(str(exo)))
    assert run["F3"]["rows"] == L.n_rows == (BOX + 1) ** 3
    A = j_ell_from_csr(L, dtype=jnp.float64)
    z = j_pad_vector(np.random.default_rng(0).uniform(size=L.n_rows), A.n_pad)
    done = 0
    while done < 500:
        res = j_power(A, z, maxiter=50, tol=1e-2, check_every=50)
        z, done = res.eigenvector, done + max(int(res.iterations), 1)
        if bool(res.converged):
            break
    lam = float(res.eigenvalue)
    assert abs(run["F3"]["eigenvalue"] - lam) <= 1e-10 * lam
    assert run["F3"]["converged"] == bool(res.converged)


def test_fem_iterations_match_jax(run_f):
    """The same meshes and flux boundaries through JAX's assembly and
    CG+AMG: the port's iteration counts."""
    from domain_decomposed_pde_solver_tpu.io import box_mesh as j_box_mesh
    from domain_decomposed_pde_solver_tpu.io.mesh import NodeSet, SideSet
    from domain_decomposed_pde_solver_tpu.models import (
        assemble_poisson_fem,
        assemble_poisson_p2,
        assemble_poisson_q2,
    )
    from domain_decomposed_pde_solver_tpu.solvers import (
        cg_solve,
        smoothed_aggregation_setup,
    )

    run, _exo = run_f

    def iterations(sy):
        A = j_choose_operator(sy.A, dtype=jnp.float64)
        b = j_pad_vector(sy.b, A.n_pad)
        M = smoothed_aggregation_setup(sy.A, dtype=jnp.float64)
        return int(cg_solve(A, b, jnp.zeros_like(b), precond=M, tol=1e-13,
                            maxiter=1000).iterations)

    mesh = j_box_mesh(BOX, BOX, BOX, "TETRA4")
    x0 = np.nonzero(np.isclose(mesh.coords[:, 0], 0.0))[0].astype(np.int64)
    mesh.node_sets = [NodeSet(id=5, nodes=x0)]
    ss = chip_smoke._plane_sideset(mesh, 77, 1.0)
    mesh.side_sets = [SideSet(id=77, elems=ss.elems, sides=ss.sides)]
    assert run["F4"]["neumann"]["iterations"] == iterations(
        assemble_poisson_fem(mesh, neumann={77: 3.25}))
    assert run["F4"]["robin"]["iterations"] == iterations(
        assemble_poisson_fem(mesh, robin={77: (2.0, 11.0)}))
    assert run["F5"]["p2"]["iterations"] == iterations(assemble_poisson_p2(
        j_box_mesh(QUAD, QUAD, QUAD, "TETRA4"), dirichlet=chip_smoke._u_p2))
    assert run["F5"]["q2"]["iterations"] == iterations(assemble_poisson_q2(
        j_box_mesh(QUAD, QUAD, QUAD, "HEX8"), dirichlet=chip_smoke._u_q2,
        f=lambda c: np.full(c.shape[0], -12.0)))
