"""The port's lattice stencil and its padded-3-D form against the JAX
package (``ops/stencil.py``, ``ops/pallas/stencil_kernel.py``).

Structured boxes from the JAX package: a single-lane-tile TETRA4 box
(``mxp = 128``), a multi-lane-tile one (free ``mx = 131``, ``mxp = 256``)
and a HEX8 box (period 1), assembled once and handed to both packages;
random vectors from numpy with fixed seeds.

Tolerances: decompositions, geometry and space maps must be equal.  The
products add the same terms in the same order as JAX's reference
(``stencil_core``), so they differ by rounding only: 1e-6 relative in f32
and 1e-12 in f64; JAX's Pallas kernel (interpret mode, f32 only) sums in
another order: 1e-6 relative.  Pad slots of every product are exactly 0.

The pad-stencil kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.io import box_mesh as j_box_mesh
from domain_decomposed_pde_solver_tpu.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu.ops import dia as j_dia
from domain_decomposed_pde_solver_tpu.ops import stencil as j_st
from domain_decomposed_pde_solver_tpu.ops.pallas import stencil_kernel as j_sk
from domain_decomposed_pde_solver_tpu.solvers.precond.amg import (
    infer_free_grid as j_infer_free_grid,
)
from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
from domain_decomposed_pde_solver_tpu_torch.ops import dia as p_dia
from domain_decomposed_pde_solver_tpu_torch.ops import stencil as p_st
from domain_decomposed_pde_solver_tpu_torch.ops import stencil_kernel as p_sk
from domain_decomposed_pde_solver_tpu_torch.utils.convert import (
    pad_stencil_from_parts,
)
from torch_parity import port_csr, rand, relerr

torch.set_num_threads(1)

TOL = {"float32": 1e-6, "float64": 1e-12}
# (box nodes per axis, element): free grids (8,10,10) single lane tile,
# (131,7,7) two lane tiles, (7,7,7) HEX8 period 1.
BOXES = {
    "tet-1tile": ((9, 9, 9), "TETRA4"),
    "tet-2tiles": ((132, 8, 8), "TETRA4"),
    "hex8": ((8, 8, 8), "HEX8"),
}
_CACHE = {}


def _parts(key):
    if key not in _CACHE:
        shape, elem = BOXES[key]
        mesh = j_box_mesh(*shape, elem_type=elem)
        sy = assemble_heat_system(mesh)
        dims = j_infer_free_grid(mesh, sy.free_to_node)
        csr = port_csr(sy)
        uj, dj = j_dia.pack_dia_host(sy.A, dtype=jnp.float32)
        up, dp = p_dia.pack_dia_host(csr, dtype=torch.float32)
        pj = j_st.stencil_parts_from_packed(uj, dj, sy.A.n_rows, dims)
        pp = p_st.stencil_parts_from_packed(up, dp, csr.n_rows, dims)
        _CACHE[key] = (sy, csr, dims, pj, pp)
    return _CACHE[key]


def _pads(key, bz=8):
    sy, csr, dims, pj, pp = _parts(key)
    return (sy, j_sk.pad_stencil_from_parts(pj, bz=bz),
            p_sk.pad_stencil_from_parts(pp, bz=bz, device="cpu"))


@pytest.mark.parametrize("key", sorted(BOXES))
def test_parts_equal_jax(key):
    _sy, _csr, _dims, pj, pp = _parts(key)
    assert pj is not None and pp is not None
    assert set(pp) == set(pj)
    for k in pj:
        if isinstance(pj[k], np.ndarray):
            np.testing.assert_array_equal(pp[k], pj[k])
        else:
            assert pp[k] == pj[k], k
    assert pp["period"] == (1 if key == "hex8" else 2)


@pytest.mark.parametrize("key", sorted(BOXES))
def test_pad_geometry_space_map_and_vectors_equal_jax(key):
    sy, Aj, Ap = _pads(key)
    for attr in ("myp", "mxp", "bz", "Z", "n_pad", "n_rows",
                 "taps", "groups", "period", "dims"):
        assert getattr(Ap, attr) == getattr(Aj, attr), attr
    np.testing.assert_array_equal(Ap.space_map(), Aj.space_map())
    np.testing.assert_array_equal(Ap.quads.numpy(), np.asarray(Aj.quads))
    assert str(Ap.corr.dtype).replace("torch.", "") == str(Aj.corr.dtype)
    np.testing.assert_array_equal(Ap.corr.float().numpy(),
                                  np.asarray(Aj.corr, np.float32))
    np.testing.assert_array_equal(Ap.pad_mask().numpy(),
                                  np.asarray(Aj.pad_mask()))
    x = rand(sy.A.n_rows, seed=1)
    for name in ("float32", "float64"):
        xp = Ap.put_vector(x, dtype=getattr(torch, name))
        np.testing.assert_array_equal(
            xp.numpy(), np.asarray(Aj.put_vector(x, dtype=getattr(jnp, name))))
        np.testing.assert_array_equal(Ap.get_vector(xp), x.astype(name))
    b = sy.b.astype(np.float32)
    np.testing.assert_array_equal(Ap.put_vector_sparse(b).numpy(),
                                  np.asarray(Aj.put_vector_sparse(b)))
    np.testing.assert_array_equal(Ap.diagonal_padded(7.0).numpy(),
                                  np.asarray(Aj.diagonal_padded(7.0)))


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("key", sorted(BOXES))
def test_matvec_reference_matches_jax(key, name):
    sy, Aj, Ap = _pads(key)
    x = rand(sy.A.n_rows, seed=2)
    xj = Aj.put_vector(x, dtype=getattr(jnp, name))
    xp = Ap.put_vector(x, dtype=getattr(torch, name))
    yj = np.asarray(Aj.matvec_reference(xj))
    yp = Ap.matvec_reference(xp)
    assert yp.dtype == getattr(torch, name)
    assert relerr(yp.numpy(), yj) <= TOL[name]
    # Pad slots stay exactly 0, and the wrapper on a CPU tensor is the
    # plain version, bit for bit.
    mask = Ap.pad_mask().numpy() == 0
    assert not np.any(yp.numpy()[mask])
    np.testing.assert_array_equal(Ap.matvec(xp).numpy(), yp.numpy())
    # Both are the assembled operator, in original order.
    ref = sy.A.matvec(x.astype(name).astype(np.float64))
    assert relerr(Ap.get_vector(yp), ref) <= TOL[name]


@pytest.mark.parametrize("key", sorted(BOXES))
def test_matvec_reference_matches_jax_pallas_interpret(key):
    sy, Aj, Ap = _pads(key)
    x = rand(sy.A.n_rows, seed=3, dtype=np.float32)
    yk = np.asarray(j_sk.pad_stencil_spmv(Aj, Aj.put_vector(x),
                                          interpret=True))
    yp = Ap.matvec(Ap.put_vector(x)).numpy()
    assert relerr(yp, yk) <= TOL["float32"]
    assert not np.any(yk[Ap.pad_mask().numpy() == 0])


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("key", ["tet-1tile", "hex8"])
def test_stencil_operator_matches_jax(key, name):
    sy, _csr, _dims, pj, pp = _parts(key)
    Sj = j_st.stencil_from_parts(pj, dtype=getattr(jnp, name))
    Sp = p_st.stencil_from_parts(pp, dtype=getattr(torch, name), device="cpu")
    assert Sp.n_pad == Sj.n_pad and Sp.dtype == getattr(torch, name)
    x = rand(Sp.n_pad, seed=4).astype(name)
    x[Sp.n_rows:] = 0
    yj = np.asarray(Sj.matvec(jnp.asarray(x)))
    yp = Sp.matvec(torch.from_numpy(x)).numpy()
    assert relerr(yp, yj) <= TOL[name]
    np.testing.assert_array_equal(Sp.diagonal_padded(5.0).numpy(),
                                  np.asarray(Sj.diagonal_padded(5.0)))
    # stencil_from_csr reaches the same operator.
    Sc = p_st.stencil_from_csr(_parts(key)[1], Sp.dims,
                               dtype=getattr(torch, name), device="cpu")
    np.testing.assert_array_equal(Sc.matvec(torch.from_numpy(x)).numpy(), yp)


def test_pad_stencil_from_jax_parts_and_from_stencil():
    """The port builds the same operator from JAX's host parts dict, and
    from an identity-layout stencil operator."""
    sy, _csr, _dims, pj, pp = _parts("tet-1tile")
    A1 = pad_stencil_from_parts(pj, device="cpu")
    A2 = p_sk.pad_stencil_from_parts(pp, device="cpu")
    A3 = p_sk.pad_stencil_from_stencil(
        p_st.stencil_from_parts(pp, device="cpu"))
    x = A1.put_vector(rand(sy.A.n_rows, seed=5))
    y1 = A1.matvec(x).numpy()
    for A in (A2, A3):
        assert (A.Z, A.myp, A.mxp) == (A1.Z, A1.myp, A1.mxp)
        np.testing.assert_array_equal(A.matvec(x).numpy(), y1)
    f32 = p_sk.pad_stencil_from_parts(pp, corr_storage="float32",
                                      device="cpu")
    assert A1.corr.dtype == torch.bfloat16 and f32.corr.dtype == torch.float32


def test_group_quads_match_jax():
    for key in BOXES:
        _sy, _csr, _dims, pj, _pp = _parts(key)
        qj, _kinds = j_sk._build_group_quads(pj["period"], pj["pats"],
                                             pj["groups"], pj["group_const"])
        qp = p_sk._build_group_quads(pj["period"], pj["pats"], pj["groups"])
        np.testing.assert_array_equal(qp, qj)


def test_kernel_tables_follow_the_groups():
    _sy, _Aj, Ap = _pads("tet-1tile")
    taps, start, quads = Ap.kernel_tables()
    assert start[0] == 0 and start[-1] == len(Ap.taps) == taps.shape[0]
    for g, tap_idx in enumerate(Ap.groups):
        got = [tuple(t) for t in taps[start[g] : start[g + 1]]]
        assert got == [Ap.taps[d] for d in tap_idx]
    np.testing.assert_array_equal(quads, Ap.quads.numpy())


def test_wrapper_dispatch_by_device():
    """On a CPU tensor the wrapper takes the plain version; the launch
    function refuses anything but CUDA tensors, before building."""
    sy, _Aj, Ap = _pads("tet-1tile")
    x = Ap.put_vector(rand(sy.A.n_rows, seed=6))
    before = _kernels.PAD_STENCIL.launches
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.pad_stencil_launch(Ap, x)
    assert _kernels.PAD_STENCIL.launches == before
    with pytest.raises(ValueError):
        Ap.matvec(x[:-1])
    with pytest.raises(TypeError):
        Ap.matvec(x.half())
