"""The port's unstructured operator and SpMV against the JAX BSG operator.

The port stores the operator as sliced ELL (``ops/bsg.py``) and evaluates
it with a hand-written CUDA kernel on the card and with ``spmv_plain`` on
the CPU.  Here on the CPU, ``spmv_plain`` is held to the JAX package's
``BSGMatrix.matvec_reference`` (and, in f32, to the Pallas kernel in
interpret mode, which casts ``x`` to float32 and so is not compared in
f64), on square and rectangular operators, always in original order
through ``get_vector``.

Tolerances: 1e-6 relative in f32 and 1e-12 in f64.  Both sides multiply
the same float32-stored coefficients by the same inputs; they differ only
in the order they add a row's products (micro-op order in JAX, column
order in the port), so the difference is summation-order rounding.

The kernel itself runs only on the card: ``tests/test_torch_cuda.py``
holds it to ``spmv_plain`` there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from domain_decomposed_pde_solver_tpu.ops.bsg import bsg_from_coo as j_bsg_from_coo
from domain_decomposed_pde_solver_tpu.ops.bsg import bsg_from_csr as j_bsg_from_csr
from domain_decomposed_pde_solver_tpu.ops.bsg import bsg_spmv as j_bsg_spmv
from domain_decomposed_pde_solver_tpu.ops.ell import ell_from_csr as j_ell_from_csr
from domain_decomposed_pde_solver_tpu.solvers.precond.amg import aggregate_greedy as j_agg
from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
from domain_decomposed_pde_solver_tpu_torch.ops.bsg import (
    SLICE,
    TILE,
    bsg_from_coo,
    bsg_from_csr,
    bsg_spmv,
    sell_operator,
    sell_pack,
    spmv_plain,
)
from domain_decomposed_pde_solver_tpu_torch.ops.dia import choose_operator
from domain_decomposed_pde_solver_tpu_torch.ops.ell import ell_from_csr
from domain_decomposed_pde_solver_tpu_torch.utils.convert import operator_from_csr
from torch_parity import (
    MESH_DIMS,
    jax_problem,
    mesh_id,
    port_csr,
    rand,
    relerr,
)

torch.set_num_threads(1)

TOL = {"float32": 1e-6, "float64": 1e-12}
DTYPES = [("float32", torch.float32, jnp.float32),
          ("float64", torch.float64, jnp.float64)]


@pytest.mark.parametrize("dims", MESH_DIMS, ids=mesh_id)
def test_rcm_perm_padding_and_diag_match_jax(dims):
    _mesh, sy = jax_problem(dims)
    Aj = j_bsg_from_csr(sy.A)
    Ap = bsg_from_csr(port_csr(sy), device="cpu")
    np.testing.assert_array_equal(Ap.perm.numpy(), np.asarray(Aj.perm))
    assert Ap.n_pad == Aj.n_pad and Ap.n_pad % TILE == 0
    assert Ap.n_rows == Aj.n_rows == sy.A.n_rows
    assert Ap.shape == (sy.A.n_rows, sy.A.n_rows)
    np.testing.assert_array_equal(
        Ap.diagonal_padded(1.0).numpy(), np.asarray(Aj.diagonal_padded(1.0))
    )


@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("dims", MESH_DIMS, ids=mesh_id)
def test_square_plain_matches_jax_reference(dims, name, tdt, jdt):
    _mesh, sy = jax_problem(dims)
    Aj = j_bsg_from_csr(sy.A)
    Ap = bsg_from_csr(port_csr(sy), device="cpu")
    x = rand(sy.A.n_rows, seed=1)
    yj = Aj.get_vector(Aj.matvec_reference(Aj.put_vector(x, dtype=jdt)))
    yp = Ap.get_vector(spmv_plain(Ap, Ap.put_vector(x, dtype=tdt)))
    assert yp.dtype == np.dtype(name)
    assert relerr(yp, yj) <= TOL[name]
    # The wrapper on a CPU tensor is the plain version, bit for bit.
    yw = Ap.get_vector(Ap.matvec(Ap.put_vector(x, dtype=tdt)))
    np.testing.assert_array_equal(yw, yp)
    # And both agree with the host CSR product in original order.
    assert relerr(yp, sy.A.matvec(x.astype(name))) <= TOL[name]


@pytest.mark.parametrize("dims", MESH_DIMS, ids=mesh_id)
def test_square_plain_matches_jax_pallas_interpret_f32(dims):
    _mesh, sy = jax_problem(dims)
    Aj = j_bsg_from_csr(sy.A)
    Ap = bsg_from_csr(port_csr(sy), device="cpu")
    x = rand(sy.A.n_rows, seed=2, dtype=np.float32)
    yj = Aj.get_vector(j_bsg_spmv(Aj, Aj.put_vector(x), interpret=True))
    yp = Ap.get_vector(Ap.matvec(Ap.put_vector(x)))
    assert relerr(yp, yj) <= TOL["float32"]


def _transfer_coo(sy, perm):
    """The AMG tentative transfer pattern of level 0: G (one entry per fine
    row) and GT (ragged rows), in the first-appearance coarse numbering."""
    agg = j_agg(sy.A)
    n_c = int(agg.max()) + 1
    seq = agg[np.argsort(perm)]
    u, first = np.unique(seq, return_index=True)
    order_c = u[np.argsort(first)]
    perm_c = np.empty(n_c, dtype=np.int64)
    perm_c[order_c] = np.arange(n_c)
    agg = perm_c[agg]
    counts = np.bincount(agg, minlength=n_c).astype(np.float64)
    tval = (1.0 / np.sqrt(counts))[agg]
    return agg, tval, n_c


@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("which", ["G", "GT"])
@pytest.mark.parametrize("dims", MESH_DIMS, ids=mesh_id)
def test_rectangular_plain_matches_jax_reference(dims, which, name, tdt, jdt):
    _mesh, sy = jax_problem(dims)
    perm = np.asarray(j_bsg_from_csr(sy.A).perm)
    agg, tval, n_c = _transfer_coo(sy, perm)
    n_pad_f = -(-sy.A.n_rows // TILE) * TILE
    n_pad_c = -(-n_c // TILE) * TILE
    if which == "G":
        args = (perm, agg, tval, n_pad_f, n_pad_c)
        win = 8
    else:
        args = (agg, perm, tval, n_c, n_pad_f)
        win = 8 if n_pad_f < 64 * TILE else 64
    Aj = j_bsg_from_coo(*args, win=win, storage="float32")
    Ap = bsg_from_coo(*args, storage="float32", device="cpu")
    assert Ap.shape == (args[3], args[4])  # the true, rectangular shape
    assert Ap.x_len == args[4] and Ap.n_pad == Aj.n_pad
    x = rand(args[4], seed=3)
    yj = np.asarray(Aj.matvec_reference(jnp.asarray(x, dtype=jdt)))
    yp = spmv_plain(Ap, torch.as_tensor(x, dtype=tdt)).numpy()
    assert yj.shape == yp.shape == (Ap.n_pad,)
    assert relerr(yp, yj) <= TOL[name]
    if name == "float32":
        yk = np.asarray(j_bsg_spmv(Aj, jnp.asarray(x, jnp.float32),
                                   interpret=True))
        assert relerr(yp, yk) <= TOL[name]


def test_shorter_input_is_zero_extended():
    """A rectangular input shorter than the input space reads as zeros
    beyond its end, as JAX's ``_as_x2`` pads it."""
    rng = np.random.default_rng(4)
    n_rows, x_len = 700, 1500
    rows = rng.integers(0, n_rows, 6000)
    cols = rng.integers(0, x_len, 6000)
    vals = rng.normal(size=6000)
    Ap = bsg_from_coo(rows, cols, vals, n_rows, x_len, device="cpu")
    Aj = j_bsg_from_coo(rows, cols, vals, n_rows, x_len, storage="float32")
    x = rand(1000, seed=5)
    x_full = np.concatenate([x, np.zeros(x_len - 1000)])
    yp = spmv_plain(Ap, torch.as_tensor(x)).numpy()
    yj = np.asarray(Aj.matvec_reference(jnp.asarray(x)))
    np.testing.assert_array_equal(
        yp, spmv_plain(Ap, torch.as_tensor(x_full)).numpy()
    )
    assert relerr(yp, yj) <= TOL["float64"]
    with pytest.raises(ValueError, match="exceeds"):
        spmv_plain(Ap, torch.zeros(x_len + 1, dtype=torch.float64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sell_pack_against_dense(seed):
    """Independent check of the sliced-ELL layout: empty rows, whole empty
    slices, duplicates and a ragged last slice, against a dense product."""
    rng = np.random.default_rng(seed)
    n_rows, x_len = 1000 + 37 * seed, 800
    live = rng.random(n_rows) < 0.5
    live[100:200] = False
    rows = np.repeat(np.flatnonzero(live), rng.integers(1, 30, live.sum()))
    cols = rng.integers(0, x_len, rows.size)
    vals = rng.normal(size=rows.size)
    D = np.zeros((n_rows, x_len))
    np.add.at(D, (rows, cols), vals)
    for storage, dt in (("float64", torch.float64), ("float32", torch.float32)):
        Ap = bsg_from_coo(rows, cols, vals, n_rows, x_len, storage=storage,
                          device="cpu")
        widths = np.diff(Ap.slice_ptr.numpy()) // SLICE
        assert Ap.n_slots == int(widths.sum()) * SLICE
        x = rand(x_len, seed=seed + 10)
        y = spmv_plain(Ap, torch.as_tensor(x, dtype=dt)).numpy()
        Dq = D if storage == "float64" else D.astype(np.float32).astype(np.float64)
        ref = Dq @ x.astype(storage).astype(np.float64)
        # Ten times the summation-order tolerance: the dense reference sums
        # duplicate entries before rounding them to the storage type.
        assert relerr(y[:n_rows], ref) <= TOL[storage] * 10
        assert np.all(y[:n_rows][~live] == 0) and np.all(y[n_rows:] == 0)


def test_sell_pack_layout_is_column_major_per_slice():
    indptr = np.array([0, 2, 2, 5] + [5] * 30)  # 32 rows: lengths 2, 0, 3, 0...
    indices = np.array([4, 7, 1, 2, 3])
    data = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    slice_ptr, cols, vals = sell_pack(indptr, indices, data, 64)
    np.testing.assert_array_equal(slice_ptr, [0, 96, 96])  # width 3, then 0
    assert cols[0] == 4 and cols[32] == 7  # row 0, slots 0 and 1
    assert cols[2] == 1 and cols[34] == 2 and cols[66] == 3  # row 2
    assert vals[1] == 0 and vals[33] == 0  # empty row 1 is padding


def test_wrapper_dispatch_by_device():
    """On a CPU tensor the wrapper takes the plain version; the launch
    function refuses anything but CUDA tensors, before building."""
    Ap = bsg_from_coo([0, 1], [1, 0], [2.0, 3.0], 2, 2, device="cpu")
    x = torch.tensor([1.0, 10.0])
    np.testing.assert_array_equal(bsg_spmv(Ap, x)[:2].numpy(), [20.0, 3.0])
    before = _kernels.SELL_SPMV.launches
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.sell_spmv(Ap.slice_ptr, Ap.cols, Ap.vals, x, Ap.n_pad)
    assert _kernels.SELL_SPMV.launches == before
    with pytest.raises(TypeError):
        bsg_spmv(Ap, x.to(torch.float16))
    Af = bsg_from_coo([0, 1], [1, 0], [2.0, 3.0], 2, 2, storage="float64",
                      device="cpu")
    with pytest.raises(TypeError, match="float64"):
        bsg_spmv(Af, x)


def test_choose_operator_routes_every_matrix_to_sliced_ell():
    _mesh, sy = jax_problem(MESH_DIMS[1])
    csr = port_csr(sy)
    A_rcm = choose_operator(csr, dtype=torch.float32, bsg="auto",
                            device="cpu")
    A_id = choose_operator(csr, dtype=torch.float64, device="cpu")
    # JAX's storage="auto": the graph Laplacian's values store as int8.
    assert A_rcm.perm is not None and A_rcm.storage == "int8"
    assert A_id.perm is None and A_id.storage == "float64"
    x = rand(sy.A.n_rows, seed=6)
    for A in (A_rcm, A_id):
        y = A.get_vector(A.matvec(A.put_vector(x, dtype=torch.float64)))
        assert relerr(y, sy.A.matvec(x)) <= TOL["float64"]


def test_operator_from_csr_adopts_a_given_perm():
    _mesh, sy = jax_problem(MESH_DIMS[1])
    perm = np.random.default_rng(7).permutation(sy.A.n_rows)
    A = operator_from_csr(port_csr(sy), perm=perm, device="cpu")
    np.testing.assert_array_equal(A.perm.numpy(), perm)
    x = rand(sy.A.n_rows, seed=8)
    y = A.get_vector(A.matvec(A.put_vector(x, dtype=torch.float64)))
    assert relerr(y, sy.A.matvec(x)) <= TOL["float64"]


@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=[d[0] for d in DTYPES])
def test_ell_matches_jax(name, tdt, jdt):
    _mesh, sy = jax_problem(MESH_DIMS[1])
    Ej = j_ell_from_csr(sy.A, dtype=jdt)
    Ep = ell_from_csr(port_csr(sy), dtype=tdt, device="cpu").repad(
        Ej.n_pad + 16)
    x = rand(sy.A.n_rows, seed=9)
    yj = Ej.get_vector(Ej.matvec(Ej.put_vector(x.astype(name))))
    yp = Ep.get_vector(Ep.matvec(Ep.put_vector(x.astype(name))))
    assert relerr(yp, yj) <= TOL[name]
    np.testing.assert_array_equal(
        Ep.diagonal_padded(1.0).numpy()[: Ej.n_pad],
        np.asarray(Ej.diagonal_padded(1.0)),
    )


def test_sell_pack_padding_column():
    """Padding slots hold value 0 and the column the packer is given (a
    column past the input for :func:`sell_operator`), in the column-major
    slot order."""
    indptr = np.array([0, 2, 2, 5] + [5] * 30)  # 32 rows: lengths 2, 0, 3, 0...
    indices = np.array([4, 7, 1, 2, 3])
    data = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    slice_ptr, cols, vals = sell_pack(indptr, indices, data, 64, pad_col=99)
    np.testing.assert_array_equal(slice_ptr, [0, 96, 96])  # width 3, then 0
    np.testing.assert_array_equal(cols[[0, 32, 64]], [4, 7, 99])  # row 0
    np.testing.assert_array_equal(cols[[1, 33, 65]], [99] * 3)  # empty row 1
    np.testing.assert_array_equal(cols[[2, 34, 66]], [1, 2, 3])  # row 2
    np.testing.assert_array_equal(vals[[2, 34, 66]], [3.0, 4.0, 5.0])
    live = vals != 0
    assert live.sum() == 5 and (cols[~live] == 99).all()


def _coo_csr(rows, cols, vals, n_rows):
    """CSR arrays of a COO pattern in ``bsg_from_coo``'s slot order (rows,
    then ascending columns, duplicates kept)."""
    o = np.lexsort((cols, rows))
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])
    return indptr, cols[o], vals[o]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sell_operator_equals_bsg_from_coo_bit_for_bit(seed):
    """A rectangular operator (empty rows, whole empty slices, duplicates,
    a row count that is not a multiple of 32) packed by ``sell_operator``
    (rows as given, no padded rows, padding slots past the input) and by
    ``bsg_from_coo`` (rows padded to 1024, padding at column 0): each
    row's slots in the same order, so the plain products agree bit for
    bit in f64, f32 and bf16 storage."""
    rng = np.random.default_rng(seed)
    n_rows, x_len = 1000 + 37 * seed, 800
    live = rng.random(n_rows) < 0.5
    live[100:200] = False
    rows = np.repeat(np.flatnonzero(live), rng.integers(1, 30, live.sum()))
    cols = rng.integers(0, x_len, rows.size)
    vals = rng.normal(size=rows.size)
    for storage, dt in (("float64", torch.float64), ("float32", torch.float32),
                        ("bfloat16", torch.float32)):
        A = bsg_from_coo(rows, cols, vals, n_rows, x_len, storage=storage,
                         device="cpu")
        S = sell_operator(*_coo_csr(rows, cols, vals, n_rows), x_len,
                          storage=storage, device="cpu")
        assert S.n_pad == n_rows and A.n_pad % TILE == 0
        assert S.n_slots == A.n_slots  # rows past n_rows are empty slices
        assert bool((S.cols[S.vals == 0] == x_len).all())
        x = torch.as_tensor(rand(x_len - 3, seed=seed + 20), dtype=dt)
        y = spmv_plain(S, x)
        assert torch.equal(y, spmv_plain(A, x)[:n_rows])
        assert not bool(y[~torch.as_tensor(live)].any())


@pytest.mark.parametrize("dims", MESH_DIMS, ids=mesh_id)
def test_sell_operator_square_matches_jax(dims):
    """The square operator in the solve's numbering (RCM, as
    ``bsg_from_csr`` gives it) packed again by ``sell_operator``: the
    product against JAX's reference in f32, and bit for bit the
    ``bsg_from_csr`` pack's on its real rows."""
    import scipy.sparse as sp

    _mesh, sy = jax_problem(dims)
    Aj = j_bsg_from_csr(sy.A)
    A = bsg_from_csr(port_csr(sy), device="cpu")
    order = np.argsort(A.perm.numpy())  # original row of internal row i
    n = sy.A.n_rows
    M = sp.csr_matrix((sy.A.data, sy.A.indices, sy.A.indptr),
                      shape=(n, n))[order][:, order].tocsr()
    M.sort_indices()
    S = sell_operator(M.indptr, M.indices, M.data, A.n_pad, storage="auto",
                      device="cpu")
    assert S.storage == A.storage == "int8" and S.n_pad == n
    x = rand(n, seed=3)
    yj = Aj.get_vector(Aj.matvec_reference(Aj.put_vector(x, dtype=jnp.float32)))
    xp = A.put_vector(x)
    y = spmv_plain(S, xp)
    y_pad = torch.zeros(A.n_pad)
    y_pad[:n] = y
    assert relerr(A.get_vector(y_pad), yj) <= TOL["float32"]
    assert torch.equal(y, spmv_plain(A, xp)[:n])
