"""The reference's other drivers and ``io/sides.py``: the port against the
JAX package, on box meshes written to Exodus.

- ``io.sides``: side tables, sideset nodes and faces, and nodesets derived
  from sidesets equal JAX's, on HEX8 and TETRA4 boxes.
- ``cli.decompose`` (``ExodusIODecomposeTest``) writes the element blocks
  JAX's writes, and prints the same lines.
- ``cli.assemble_test`` (``ExodusAssembleTest``) and ``cli.combine``
  (``mpi_output_combiner.py``) give JAX's exit codes and output.
All three are host-only and exact: the comparisons are equalities.
"""

import numpy as np
import pytest

from domain_decomposed_pde_solver_tpu.cli import (
    assemble_test as j_assemble_test,
    combine as j_combine,
    decompose as j_decompose,
)
from domain_decomposed_pde_solver_tpu.io import box_mesh as j_box_mesh
from domain_decomposed_pde_solver_tpu.io import mesh as j_mesh
from domain_decomposed_pde_solver_tpu.io import sides as j_sides
from domain_decomposed_pde_solver_tpu_torch.cli import (
    assemble_test,
    combine,
    decompose,
)
from domain_decomposed_pde_solver_tpu_torch.io import (
    box_mesh,
    read_exodus,
    write_exodus,
)
from domain_decomposed_pde_solver_tpu_torch.io import mesh as p_mesh
from domain_decomposed_pde_solver_tpu_torch.io import sides
from domain_decomposed_pde_solver_tpu_torch.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu_torch.utils import (
    print_csr_matrix,
    print_vector,
)
from torch_parity import plane_sides

ELEMS = ["TETRA4", "HEX8"]


@pytest.mark.parametrize("elem_type,n_sides,shell",
                         [("TETRA4", 4, False), ("HEX8", 6, False),
                          ("TRI3", 3, False), ("QUAD4", 4, False),
                          ("TRI3", 5, True), ("QUAD4", 6, True)])
def test_side_tables_match_jax(elem_type, n_sides, shell):
    for s in range(1, n_sides + 1):
        assert (sides.side_local_nodes(elem_type, s, shell=shell)
                == j_sides.side_local_nodes(elem_type, s, shell=shell))
    with pytest.raises(ValueError):
        sides.side_local_nodes(elem_type, n_sides + 3, shell=shell)
    with pytest.raises(ValueError):
        j_sides.side_local_nodes(elem_type, n_sides + 3, shell=shell)


def _with_sidesets(elem_type):
    """The same 5x4x3 box from both packages, with a sideset on x = 1 (id
    77) and one on y = 0 (id 5)."""
    out = []
    for mod_box, mod_mesh in ((box_mesh, p_mesh), (j_box_mesh, j_mesh)):
        m = mod_box(5, 4, 3, elem_type=elem_type)
        m.side_sets = [
            mod_mesh.SideSet(id=ss, elems=e, sides=s)
            for ss, (e, s) in ((77, plane_sides(m, 0, 1.0,
                                                sides.side_local_nodes)),
                               (5, plane_sides(m, 1, 0.0,
                                               sides.side_local_nodes)))
        ]
        out.append(m)
    return out


@pytest.mark.parametrize("elem_type", ELEMS)
def test_sideset_resolution_matches_jax(elem_type):
    pm, jm = _with_sidesets(elem_type)
    for ps, js in zip(pm.side_sets, jm.side_sets):
        nodes = sides.sideset_nodes(pm, ps)
        np.testing.assert_array_equal(nodes, j_sides.sideset_nodes(jm, js))
        faces = sides.sideset_faces(pm, ps)
        j_faces = j_sides.sideset_faces(jm, js)
        assert len(faces) == len(j_faces) == 1
        np.testing.assert_array_equal(faces[0], j_faces[0])
        assert faces[0].shape[1] == (4 if elem_type == "HEX8" else 3)


@pytest.mark.parametrize("elem_type", ELEMS)
def test_nodesets_from_sidesets_match_jax(elem_type):
    pm, jm = _with_sidesets(elem_type)
    values = {77: 300}
    p = sides.nodesets_from_sidesets(pm, values)
    j = j_sides.nodesets_from_sidesets(jm, values)
    assert [(s.id, s.name) for s in p.node_sets] == [
        (s.id, s.name) for s in j.node_sets]
    for a, b in zip(p.node_sets, j.node_sets):
        np.testing.assert_array_equal(a.nodes, b.nodes)
    assert len(p.node_sets) == len(pm.node_sets) + 2  # the input is kept
    # The derived sets are Dirichlet data of the heat model.
    assert assemble_heat_system(p).n_free < assemble_heat_system(pm).n_free


def _box_file(tmp_path, elem_type="TETRA4"):
    path = tmp_path / f"box-{elem_type}.exo"
    write_exodus(str(path), box_mesh(6, 5, 4, elem_type=elem_type))
    return path


@pytest.mark.parametrize("elem_type,nparts",
                         [("TETRA4", 3), ("HEX8", 4), ("TETRA4", 1)])
def test_decompose_writes_jax_blocks(tmp_path, capsys, elem_type, nparts):
    src = _box_file(tmp_path, elem_type)
    outs = {}
    for who, mod in (("port", decompose), ("jax", j_decompose)):
        dst = tmp_path / f"{who}.exo"
        rc = mod.main(["--input", str(src), "--output", str(dst),
                       "--partitions", str(nparts), "--verbose"])
        text = capsys.readouterr().out.replace(str(dst), "OUT")
        outs[who] = (rc, text, read_exodus(str(dst)))
    (rc_p, text_p, pm), (rc_j, text_j, jm) = outs["port"], outs["jax"]
    assert rc_p == rc_j == 0
    assert text_p == text_j
    assert len(pm.blocks) == len(jm.blocks) == nparts
    for bp, bj in zip(pm.blocks, jm.blocks):
        assert (bp.id, bp.elem_type) == (bj.id, bj.elem_type)
        np.testing.assert_array_equal(bp.conn, bj.conn)
    np.testing.assert_array_equal(pm.coords, jm.coords)


@pytest.mark.parametrize("case", ["tet", "hex", "missing", "bad-file"])
def test_assemble_test_matches_jax(tmp_path, capsys, case):
    if case == "missing":
        src = tmp_path / "nope.exo"
    elif case == "bad-file":
        src = tmp_path / "bad.exo"
        src.write_bytes(b"not a netCDF file")
    else:
        src = _box_file(tmp_path, "TETRA4" if case == "tet" else "HEX8")
    got = []
    for mod in (assemble_test, j_assemble_test):
        rc = mod.main(["--input", str(src), "--verbose"])
        cap = capsys.readouterr()
        got.append((rc, cap.out, cap.err))
    assert got[0] == got[1]
    assert got[0][0] == (0 if case in ("tet", "hex") else 1)


def test_combine_matches_jax(tmp_path, capsys):
    sy = assemble_heat_system(box_mesh(4, 3, 3, elem_type="TETRA4"))
    parts = np.arange(sy.n_free) % 3
    prefix = str(tmp_path / "mpi-proc-")
    print_csr_matrix(sy.A, "Laplacian: A", prefix, parts=parts, nparts=3)
    print_vector(sy.b, "RHS: B", prefix, parts=parts, nparts=3)
    texts = []
    for who, mod in (("port", combine), ("jax", j_combine)):
        out = tmp_path / f"{who}.out"
        assert mod.main(["--prefix", prefix, "--output", str(out)]) == 0
        assert capsys.readouterr().out == f"Wrote {out}\n"
        texts.append(out.read_text())
    assert texts[0] == texts[1]
    lines = texts[0].splitlines()
    assert lines[0] == "[Laplacian: A]" and "[RHS: B]" in lines
    assert len(lines) == 2 + 2 * sy.n_free


def test_combine_without_dumps_raises_as_jax(tmp_path):
    prefix = str(tmp_path / "none-")
    for mod in (combine, j_combine):
        with pytest.raises(FileNotFoundError):
            mod.main(["--prefix", prefix, "--output",
                      str(tmp_path / "o.out")])
