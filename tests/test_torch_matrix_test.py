"""The matrix test (``ExodusMatrixTest``): the port against the JAX package.

- ``assemble_full_laplacian`` builds JAX's CSR array for array.
- ``power_method`` on the f64 ELL operator gives JAX's eigenvalue within
  1e-10 relative and JAX's iteration count (its residual is read on the
  check iterations only, as JAX's is).
- ``cli.matrix_test.main`` prints JAX's report lines; the numbers agree to
  8 significant digits (the same f64 iteration summed in another order).
- ``--partitions 2`` runs the partitioned power method (held to JAX's in
  ``test_torch_parallel_cli.py``); only a mesh that spans two devices in
  one process raises ``NotImplementedError``, naming the multi-process
  route.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.cli.matrix_test import main as j_main
from domain_decomposed_pde_solver_tpu.io import (
    box_mesh as j_box_mesh,
    refine_uniform as j_refine_uniform,
)
from domain_decomposed_pde_solver_tpu.models import (
    assemble_full_laplacian as j_full_laplacian,
)
from domain_decomposed_pde_solver_tpu.ops import (
    ell_from_csr as j_ell_from_csr,
    pad_vector as j_pad_vector,
)
from domain_decomposed_pde_solver_tpu.solvers import power_method as j_power
from domain_decomposed_pde_solver_tpu_torch.cli.matrix_test import main
from domain_decomposed_pde_solver_tpu_torch.io import (
    box_mesh,
    refine_uniform,
    write_exodus,
)
from domain_decomposed_pde_solver_tpu_torch.models import (
    assemble_full_laplacian,
)
from domain_decomposed_pde_solver_tpu_torch.ops.ell import ell_from_csr
from domain_decomposed_pde_solver_tpu_torch.solvers import power_method

torch.set_num_threads(1)

MESHES = [((6, 5, 4), "TETRA4", 0), ((5, 4, 4), "HEX8", 0),
          ((4, 4, 3), "TETRA4", 1)]
MESH_IDS = ["{}x{}x{}-{}-r{}".format(*d, e, r) for d, e, r in MESHES]


@pytest.mark.parametrize("dims,elem,levels", MESHES, ids=MESH_IDS)
def test_full_laplacian_matches_jax(dims, elem, levels):
    L = assemble_full_laplacian(refine_uniform(box_mesh(*dims, elem), levels))
    J = j_full_laplacian(j_refine_uniform(j_box_mesh(*dims, elem), levels))
    assert L.shape == J.shape
    for name in ("indptr", "indices", "data"):
        a, b = getattr(L, name), getattr(J, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("maxiter,check_every,tol",
                         [(500, 50, 1e-2), (120, 7, 1e-6), (0, 1, 1e-2)],
                         ids=["reference", "every-7", "no-iteration"])
def test_power_method_matches_jax(maxiter, check_every, tol):
    mesh = box_mesh(7, 6, 5, "TETRA4")
    L = assemble_full_laplacian(mesh)
    z0 = np.random.default_rng(1).uniform(size=L.n_rows)
    A = ell_from_csr(L, dtype=torch.float64, device="cpu")
    res = power_method(A, A.put_vector(z0), maxiter=maxiter, tol=tol,
                       check_every=check_every)
    JA = j_ell_from_csr(j_full_laplacian(j_box_mesh(7, 6, 5, "TETRA4")),
                        dtype=jnp.float64)
    jres = j_power(JA, j_pad_vector(z0, JA.n_pad), maxiter=maxiter, tol=tol,
                   check_every=check_every)
    assert res.iterations == int(jres.iterations)
    assert res.converged == bool(jres.converged)
    lam = float(jres.eigenvalue)
    assert abs(res.eigenvalue - lam) <= 1e-10 * max(abs(lam), 1.0)
    jr = float(jres.residual)
    assert abs(res.residual - jr) <= 1e-10 * max(abs(lam), jr)


_REPORT = re.compile(r"^\s*iteration (\d+): lambda ~= (\S+) residual (\S+)$"
                     r"|^lambda_max ~= (\S+) after (\d+) iterations "
                     r"\(residual (\S+), converged=(\w+)\)$", re.M)


def _numbers(text):
    """Every report line's fields, the floats to 8 significant digits."""
    out = []
    for m in _REPORT.finditer(text):
        out.append(tuple(
            f"{float(g):.8g}" if re.fullmatch(r"[-+.\deE]+", g) and "." in g
            else g
            for g in m.groups() if g is not None))
    return out


@pytest.mark.parametrize("extra", [[], ["--iterations", "130",
                                        "--reportFrequency", "40",
                                        "--tolerance", "1e-9"]],
                         ids=["defaults", "uneven-chunks"])
def test_cli_prints_jax_report_lines(tmp_path, capsys, extra):
    path = tmp_path / "box.exo"
    write_exodus(str(path), box_mesh(6, 6, 5, "TETRA4"))
    assert main(["--input", str(path), "--cpu"] + extra) == 0
    ours = capsys.readouterr().out
    assert j_main(["--input", str(path), "--cpu"] + extra) == 0
    theirs = capsys.readouterr().out
    assert _numbers(ours) == _numbers(theirs)
    assert len(_numbers(ours)) >= 2
    assert ours.splitlines()[-1].startswith("lambda_max ~= ")


def test_cli_partitions_raise(tmp_path):
    """``--partitions 2`` no longer raises: it runs over two parts on the
    one device.  What still raises is a mesh over two devices."""
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        make_device_mesh,
    )

    path = tmp_path / "box.exo"
    write_exodus(str(path), box_mesh(3, 3, 3, "TETRA4"))
    report = {}
    assert main(["--input", str(path), "--cpu", "--partitions", "2"],
                report=report) == 0
    assert report["plan"].nparts == 2
    with pytest.raises(NotImplementedError, match="initialize_multihost"):
        make_device_mesh(2, ["cpu", "cuda:0"])


def test_cli_missing_input_returns_1(tmp_path, capsys):
    assert main(["--input", str(tmp_path / "nope.exo"), "--cpu"]) == 1
    assert "error" in capsys.readouterr().err


def test_cli_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = tmp_path / "box.exo"
    write_exodus(str(path), box_mesh(3, 3, 3, "TETRA4"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--input", str(path)])
