"""Host modules of the PyTorch port against the JAX package.

The port carries its own copies of the numpy-only host modules (mesh I/O,
box meshes, refinement, CSR, heat assembly, the native library loader),
because importing any submodule of the JAX package imports JAX.  These
tests hold the copies to the JAX originals: same meshes, the same assembled
CSR and right-hand side bit for bit, and solution files each package reads
back from the other.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import domain_decomposed_pde_solver_tpu.io as jio
import domain_decomposed_pde_solver_tpu.models as jmodels
import domain_decomposed_pde_solver_tpu_torch.io as pio
import domain_decomposed_pde_solver_tpu_torch.models as pmodels
from domain_decomposed_pde_solver_tpu_torch.utils import native as pnative
from domain_decomposed_pde_solver_tpu_torch.utils.convert import (
    heat_system_from_numpy,
)
from domain_decomposed_pde_solver_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = [
    ((6, 6, 6), "TETRA4", 1),
    ((7, 6, 5), "TETRA4", 1),
    ((9, 8, 7), "HEX8", 0),
    ((5, 5, 5), "HEX8", 1),
]
MESH_IDS = ["{}x{}x{}-{}-r{}".format(*d, e, r) for d, e, r in MESHES]


def _meshes(dims, elem, levels):
    jm = jio.refine_uniform(jio.box_mesh(*dims, elem_type=elem), levels)
    pm = pio.refine_uniform(pio.box_mesh(*dims, elem_type=elem), levels)
    return jm, pm


@pytest.mark.parametrize("dims,elem,levels", MESHES, ids=MESH_IDS)
def test_box_and_refine_match_jax(dims, elem, levels):
    jm, pm = _meshes(dims, elem, levels)
    assert pm.num_nodes == jm.num_nodes
    np.testing.assert_array_equal(pm.coords, jm.coords)
    assert len(pm.blocks) == len(jm.blocks)
    for pb, jb in zip(pm.blocks, jm.blocks):
        assert pb.elem_type == jb.elem_type
        np.testing.assert_array_equal(pb.conn, jb.conn)
    assert [(s.id, s.name) for s in pm.node_sets] == [
        (s.id, s.name) for s in jm.node_sets
    ]
    for ps, js in zip(pm.node_sets, jm.node_sets):
        np.testing.assert_array_equal(ps.nodes, js.nodes)


@pytest.mark.parametrize("dims,elem,levels", MESHES, ids=MESH_IDS)
def test_assembly_matches_jax_exactly(dims, elem, levels):
    jm, pm = _meshes(dims, elem, levels)
    js = jmodels.assemble_heat_system(jm)
    ps = pmodels.assemble_heat_system(pm)
    assert ps.A.shape == js.A.shape
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(ps.A, field), getattr(js.A, field))
    for field in ("b", "free_to_node", "node_to_free", "degree",
                  "bdry_rows", "bdry_cols"):
        np.testing.assert_array_equal(getattr(ps, field), getattr(js, field))


def test_heat_system_from_numpy_adopts_jax_arrays():
    jm = jio.refine_uniform(jio.box_mesh(6, 6, 6, elem_type="TETRA4"), 1)
    js = jmodels.assemble_heat_system(jm)
    ps = heat_system_from_numpy(
        js.A.indptr, js.A.indices, js.A.data, js.A.shape, js.b,
        js.free_to_node, num_nodes=jm.num_nodes,
        bdry_rows=js.bdry_rows, bdry_cols=js.bdry_cols,
    )
    np.testing.assert_array_equal(ps.A.data, js.A.data)
    np.testing.assert_array_equal(ps.node_to_free, js.node_to_free)
    np.testing.assert_array_equal(ps.degree, js.degree)
    assert ps.n_free == js.n_free


def test_port_solution_file_reads_back_through_jax(tmp_path):
    """A port-written solution file reads back identically through the
    JAX reader (and the port's own)."""
    jm, pm = _meshes((6, 6, 6), "TETRA4", 1)
    ps = pmodels.assemble_heat_system(pm)
    u = np.random.default_rng(0).uniform(100, 1000, ps.n_free)
    path = str(tmp_path / "port.exo")
    with pio.ExodusSolutionWriter(path, pm) as w:
        w.write_solution(u, ps.free_to_node, 1)
        w.write_solution(u * 0.5, ps.free_to_node, 2)
    jn, jt, jv = jio.read_nodal_vars(path)
    pn, pt, pv = pio.read_nodal_vars(path)
    assert jn == pn == ["Steady-State Heat Solution"]
    np.testing.assert_array_equal(jt, pt)
    np.testing.assert_array_equal(jv, pv)
    assert jv.shape == (3, 1, pm.num_nodes)
    np.testing.assert_array_equal(jv[0, 0], pm.boundary_write_values())
    np.testing.assert_array_equal(jv[1, 0, ps.free_to_node], u)
    np.testing.assert_array_equal(jv[2, 0, ps.free_to_node], u * 0.5)


def test_mesh_file_roundtrip_between_packages(tmp_path):
    jm, pm = _meshes((5, 4, 3), "TETRA4", 1)
    p_path, j_path = str(tmp_path / "p.exo"), str(tmp_path / "j.exo")
    pio.write_exodus(p_path, pm)
    jio.write_exodus(j_path, jm)
    from_port = jio.read_exodus(p_path)
    from_jax = pio.read_exodus(j_path)
    for a, b in ((from_port, jm), (from_jax, pm)):
        assert a.num_nodes == b.num_nodes
        np.testing.assert_array_equal(a.coords, b.coords)
        np.testing.assert_array_equal(a.blocks[0].conn, b.blocks[0].conn)
        assert [s.id for s in a.node_sets] == [s.id for s in b.node_sets]


def test_native_library_builds_into_the_port_build_dir():
    """The port compiles the shared source into its own gitignored build
    directory, never over the tracked library of the JAX package."""
    assert pnative._SRC == pnative._ROOT / "native" / "ddps_native.cpp"
    assert pnative._SO.parent == pnative._ROOT / "build" / "native"
    assert pnative._SO != pnative._SRC.with_name("libddps_native.so")
    assert pnative.native_available()
    assert pnative._SO.exists()


def test_resolve_device_is_explicit():
    """The card unless the caller asks for the CPU; no silent fallback."""
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        assert resolve_device(None) == torch.device("cuda", 0)
    else:
        for dev in ("cuda", None):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                resolve_device(dev)
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_port_import_leaves_jax_out():
    """Importing the whole port in a fresh interpreter loads no JAX."""
    code = (
        "import sys\n"
        "import domain_decomposed_pde_solver_tpu_torch as p\n"
        "import domain_decomposed_pde_solver_tpu_torch.io\n"
        "import domain_decomposed_pde_solver_tpu_torch.models\n"
        "import domain_decomposed_pde_solver_tpu_torch.ops\n"
        "import domain_decomposed_pde_solver_tpu_torch.ops._kernels\n"
        "import domain_decomposed_pde_solver_tpu_torch.solvers\n"
        "import domain_decomposed_pde_solver_tpu_torch.utils.convert\n"
        "import domain_decomposed_pde_solver_tpu_torch.utils.native\n"
        "import domain_decomposed_pde_solver_tpu_torch.cli.solve\n"
        "import domain_decomposed_pde_solver_tpu_torch.parallel\n"
        "import domain_decomposed_pde_solver_tpu_torch.solvers.mixed\n"
        "import domain_decomposed_pde_solver_tpu_torch.utils.timers\n"
        "import domain_decomposed_pde_solver_tpu_torch.utils.checkpoint\n"
        "import domain_decomposed_pde_solver_tpu_torch.cli.matrix_test\n"
        "import domain_decomposed_pde_solver_tpu_torch.cli.decompose\n"
        "import domain_decomposed_pde_solver_tpu_torch.cli.assemble_test\n"
        "import domain_decomposed_pde_solver_tpu_torch.cli.combine\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'domain_decomposed_pde_solver_tpu.')) or m == "
        "'domain_decomposed_pde_solver_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_have_no_jax_import():
    import re

    pkg = os.path.join(REPO, "domain_decomposed_pde_solver_tpu_torch")
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    offenders = []
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    if pat.search(fh.read()):
                        offenders.append(f)
    assert offenders == []
