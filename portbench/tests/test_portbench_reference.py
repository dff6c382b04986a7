"""The benchmark's reference against the program on the CPU at small
sizes: the frozen mesh generator gives the program's meshes, and the
reference's residual of the program's own exact answers is at rounding."""

import numpy as np
import pytest
import scipy.sparse.linalg as sla

from portbench.reference import heat, meshgen


def _port_exact(mesh, temps):
    from domain_decomposed_pde_solver_tpu_torch.models.heat import (
        assemble_heat_system,
    )

    sy = assemble_heat_system(mesh)
    bval = np.zeros(mesh.num_nodes)
    for ns in sorted(mesh.node_sets, key=lambda s: -s.id):
        bval[ns.nodes] = temps[ns.id]
    b = np.zeros(sy.n_free)
    np.add.at(b, sy.bdry_rows, bval[sy.bdry_cols])
    return sy, sla.spsolve(sy.A.to_scipy().tocsc(), b)


@pytest.mark.parametrize("cells,refine", [((8, 8, 8), 1), ((6, 7, 5), 1),
                                          ((9, 9, 9), 0)])
def test_meshgen_is_the_programs_generator(cells, refine):
    from domain_decomposed_pde_solver_tpu_torch.io import (
        box_mesh,
        refine_uniform,
    )

    m = meshgen.make_mesh(cells, refine)
    pm = box_mesh(*cells, "TETRA4")
    if refine:
        pm = refine_uniform(pm, refine)
    assert np.array_equal(m.coords, pm.coords)
    assert np.array_equal(m.conn, pm.blocks[0].conn)
    assert {ns.id for ns in pm.node_sets} == set(m.node_sets)
    for ns in pm.node_sets:
        assert np.array_equal(m.node_sets[ns.id], ns.nodes)


@pytest.mark.parametrize("cells,refine", [((8, 8, 8), 1), ((6, 7, 5), 1)])
def test_mesh_reference_against_the_program(cells, refine):
    from portbench.systems.mesh_session import mesh_model

    m = meshgen.make_mesh(cells, refine)
    temps = {100: 312.5, 1000: 861.0}
    sy, x = _port_exact(mesh_model(m), temps)
    ref = heat.MeshHeat(m)
    assert (ref.n_free, ref.nnz) == (sy.n_free, sy.A.nnz)
    assert ref.relres(x, temps) < 1e-12
    assert 0.5e-6 < ref.relres(x * (1 + 1e-6), temps) < 2e-6


@pytest.mark.parametrize("n", [8, 11])
def test_lattice_reference_against_the_program(n):
    from domain_decomposed_pde_solver_tpu_torch.models.structured import (
        structured_box_system,
    )

    temps = {100: 250.0, 1000: 900.0}
    m = meshgen.box_tet4(n, n, n)
    from portbench.systems.mesh_session import mesh_model

    sy, x = _port_exact(mesh_model(m), temps)
    ref = heat.BoxHeat(n)
    assert (ref.n_free, ref.nnz) == (sy.n_free, sy.A.nnz)
    assert ref.relres(x, temps) < 1e-12
    x2 = x.copy()
    x2[len(x2) // 2] += 1.0
    assert ref.relres(x2, temps) == pytest.approx(
        heat.MeshHeat(m).relres(x2, temps), rel=1e-10)
    # the structured route's system is the same system
    s2 = structured_box_system(n, n, n, "TETRA4")
    assert np.array_equal(s2.A.indices, sy.A.indices)


def test_round_to_float16_matches_torch():
    import torch

    x = np.random.default_rng(3).uniform(100.0, 1000.0, size=4096)
    want = torch.from_numpy(x).float().to(torch.float16).double().numpy()
    got = heat.round_to_float16(x)
    assert np.array_equal(got, want)
    # nearer than bfloat16: ten mantissa bits, a relative step of 2**-11
    assert np.max(np.abs(got - x) / x) <= 2.0**-11
    assert np.max(np.abs(got - x) / x) > 2.0**-13
