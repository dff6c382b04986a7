"""The port on the card: the hand-written kernels (sliced-ELL SpMV,
pad-stencil, DIA, chunked sliced-ELL SpMV, fused Jacobi-PCG) against their
plain PyTorch versions, and the solves through them against the same
solves on the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without JAX (``tests/conftest.py`` imports JAX; skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Kernel tolerances: each kernel and its plain version add the same
products, in the same or another order, the kernel with fused
multiply-adds, so they differ by rounding only: 1e-5 relative in f32,
1e-12 in f64.  The fused CG kernel and its plain version run the same
recurrence with dots summed in another order (the kernel per block in
double, then across blocks), so they stop within 2 iterations of each
other and their answers agree to 1e-4 relative (f32 CG to 1e-6).
"""

import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu_torch import SteadyHeatSolver
from domain_decomposed_pde_solver_tpu_torch.io import box_mesh, refine_uniform
from domain_decomposed_pde_solver_tpu_torch.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
from domain_decomposed_pde_solver_tpu_torch.ops.bsg import (
    bsg_from_coo,
    bsg_from_csr,
    bsg_spmv,
    spmv_plain,
)
from domain_decomposed_pde_solver_tpu_torch.ops.csr import CSRMatrix
from domain_decomposed_pde_solver_tpu_torch.ops.dia import (
    choose_operator,
    dia_from_csr,
)
from domain_decomposed_pde_solver_tpu_torch.ops.dia_kernel import dia_matvec_plain
from domain_decomposed_pde_solver_tpu_torch.solvers.precond.amg import (
    infer_free_grid,
)

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "float64": 1e-12}
BC = {100: 80.0, 1000: 25.0}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the port's hand-written kernels)")
    return torch.device("cuda", 0)


def _relerr(a, b) -> float:
    a = a.double().cpu()
    b = b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _mesh():
    return refine_uniform(box_mesh(8, 8, 8, elem_type="TETRA4"), 1)


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_kernel_matches_plain_square(cuda_device, name):
    sy = assemble_heat_system(_mesh())
    A = bsg_from_csr(sy.A, device=cuda_device)
    rng = np.random.default_rng(11)
    x = A.put_vector(rng.normal(size=sy.A.n_rows), dtype=getattr(torch, name))
    before = _kernels.SELL_SPMV.launches
    y = bsg_spmv(A, x)
    assert _kernels.SELL_SPMV.launches == before + 1
    torch.cuda.synchronize()
    assert y.device == cuda_device and y.dtype == x.dtype
    assert _relerr(y, spmv_plain(A, x)) <= TOL[name]
    y_host = A.get_vector(y)
    ref = sy.A.matvec(A.get_vector(x).astype(np.float64))
    assert np.abs(y_host - ref).max() <= TOL[name] * np.abs(ref).max()


@pytest.mark.parametrize("storage", ["float32", "float64"])
def test_kernel_matches_plain_rectangular_with_empty_rows(cuda_device, storage):
    rng = np.random.default_rng(12)
    n_rows, x_len = 3000, 2000
    live = rng.random(n_rows) < 0.5
    live[500:600] = False
    rows = np.repeat(np.flatnonzero(live), rng.integers(1, 25, live.sum()))
    cols = rng.integers(0, x_len, rows.size)
    A = bsg_from_coo(rows, cols, rng.normal(size=rows.size), n_rows, x_len,
                     storage=storage, device=cuda_device)
    x = torch.as_tensor(rng.normal(size=x_len - 5),
                        dtype=getattr(torch, storage), device=cuda_device)
    y = bsg_spmv(A, x)
    assert _relerr(y, spmv_plain(A, x)) <= TOL[storage]
    y = y.cpu().numpy()
    assert np.all(y[:n_rows][~live] == 0) and np.all(y[n_rows:] == 0)


def test_kernel_refuses_mixed_inputs(cuda_device):
    A = bsg_from_coo([0, 1], [1, 0], [2.0, 3.0], 2, 2, storage="float64",
                     device=cuda_device)
    with pytest.raises(TypeError):
        bsg_spmv(A, torch.ones(2, device=cuda_device))  # f64 storage, f32 x
    with pytest.raises(ValueError):
        bsg_spmv(A, torch.ones(2, dtype=torch.float64))  # x on the CPU


@pytest.mark.parametrize("name,slack", [("float64", 0), ("float32", 1)])
def test_slice_on_the_card_matches_the_cpu(cuda_device, name, slack):
    dtype = getattr(torch, name)
    tol = 1e-10 if name == "float64" else 1e-6
    mesh = _mesh()
    gpu = SteadyHeatSolver(mesh, dtype=dtype, device=cuda_device)
    cpu = SteadyHeatSolver(mesh, dtype=dtype, device="cpu")
    _kernels.SELL_SPMV.launches = 0
    u1, r1 = gpu.solve(tol=tol)
    u2, r2 = gpu.solve(bc=BC, tol=tol)
    assert _kernels.SELL_SPMV.launches > 0
    c1, q1 = cpu.solve(tol=tol)
    c2, q2 = cpu.solve(bc=BC, tol=tol)
    for r, q, u, c in ((r1, q1, u1, c1), (r2, q2, u2, c2)):
        assert r.converged and q.converged
        assert abs(r.iterations - q.iterations) <= slack
        scale = np.abs(c).max()
        assert np.abs(u - c).max() <= (1e-10 if name == "float64" else 1e-4) * scale


def _box_system(shape, elem):
    mesh = box_mesh(*shape, elem_type=elem)
    sy = assemble_heat_system(mesh)
    return mesh, sy, infer_free_grid(mesh, sy.free_to_node)


@pytest.mark.parametrize("corr", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("shape,elem", [((9, 9, 9), "TETRA4"),
                                        ((132, 8, 8), "TETRA4"),
                                        ((8, 8, 8), "HEX8")],
                         ids=["tet-1tile", "tet-2tiles", "hex8"])
def test_pad_stencil_kernel_matches_plain(cuda_device, shape, elem, name,
                                          corr):
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        pad_stencil_from_stencil,
    )

    _mesh, sy, dims = _box_system(shape, elem)
    st = choose_operator(sy.A, dtype=torch.float32, grid_dims=dims,
                         device=cuda_device)
    A = pad_stencil_from_stencil(st, corr_storage=corr)
    assert A.corr.dtype == getattr(torch, corr)
    rng = np.random.default_rng(21)
    x = A.put_vector(rng.normal(size=sy.A.n_rows), dtype=getattr(torch, name))
    entry = f"ddps_pad_stencil_{name[0]}{name[-2:]}_" + (
        "bf16" if corr == "bfloat16" else "f32")
    before = _kernels.PAD_STENCIL.by_entry[entry]
    y = A.matvec(x)
    assert _kernels.PAD_STENCIL.by_entry[entry] == before + 1
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and y.device == cuda_device
    assert _relerr(y, A.matvec_reference(x)) <= TOL[name]
    assert not torch.any(y[A.pad_mask() == 0])
    ref = sy.A.matvec(A.get_vector(x).astype(np.float64))
    assert np.abs(A.get_vector(y) - ref).max() <= TOL[name] * np.abs(ref).max()


@pytest.mark.parametrize("z_layers", [1, 3, 5, 7, 16])
@pytest.mark.parametrize("name,corr", [("float32", "bfloat16"),
                                       ("float64", "float32")])
@pytest.mark.parametrize("shape,elem", [((9, 9, 9), "TETRA4"),
                                        ((132, 8, 8), "TETRA4"),
                                        ((8, 8, 8), "HEX8")],
                         ids=["tet-mxp128", "tet-mxp256", "hex8"])
def test_pad_stencil_kernel_z_depths(cuda_device, shape, elem, name, corr,
                                     z_layers):
    """Every z-depth a launch may take, including depths that do not
    divide Z (16 here) and one block over all of Z, against the plain
    version; pads exactly 0."""
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        pad_stencil_from_stencil,
    )

    _mesh, sy, dims = _box_system(shape, elem)
    st = choose_operator(sy.A, dtype=torch.float32, grid_dims=dims,
                         device=cuda_device)
    A = pad_stencil_from_stencil(st, corr_storage=corr)
    assert A.Z % 3 and A.Z % 5 and A.Z % 7
    x = A.put_vector(np.random.default_rng(25).normal(size=sy.A.n_rows),
                     dtype=getattr(torch, name))
    y = _kernels.pad_stencil_launch(A, x, z_layers=z_layers)
    torch.cuda.synchronize()
    assert _relerr(y, A.matvec_reference(x)) <= TOL[name]
    assert not torch.any(y[A.pad_mask() == 0])
    # Every output's sum has one order, whatever the depth: bit-identical.
    assert torch.equal(y, A.matvec(x))


def _split_first_group(A):
    """The same operator with its first group of taps split in two: a
    grouping the kernel has no compile-time instance for."""
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        pad_stencil_from_parts,
    )

    g0 = A.groups[0]
    half = len(g0) // 2
    groups = (g0[:half], g0[half:]) + A.groups[1:]
    const = A.const_vals.cpu().numpy()
    parts = dict(
        pats=A.pats.cpu().numpy(), taps=A.taps, groups=groups,
        group_const=(A.group_const[0],) + A.group_const,
        const_vals=np.concatenate([const[:1], const]),
        corr_pad=A.extract_device(A.corr.float()).cpu().numpy(),
        dims=A.dims, period=A.period)
    return pad_stencil_from_parts(parts, corr_storage=str(A.corr.dtype)[6:],
                                  device=A.device)


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("shape,elem", [((9, 9, 9), "TETRA4"),
                                        ((8, 8, 8), "HEX8")],
                         ids=["tet", "hex8"])
def test_pad_stencil_kernel_on_any_grouping(cuda_device, shape, elem, name):
    """A grouping other than the two lattices' (first group split in two)
    runs through the kernel's table-driven instance, to rounding of the
    plain version's sums."""
    _mesh, sy, dims = _box_system(shape, elem)
    st = choose_operator(sy.A, dtype=torch.float32, grid_dims=dims,
                         device=cuda_device)
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        pad_stencil_from_stencil,
    )

    A = pad_stencil_from_stencil(st)
    B = _split_first_group(A)
    assert len(B.groups) == len(A.groups) + 1
    x = A.put_vector(np.random.default_rng(26).normal(size=sy.A.n_rows),
                     dtype=getattr(torch, name))
    before = _kernels.PAD_STENCIL.launches
    y = B.matvec(x)
    assert _kernels.PAD_STENCIL.launches == before + 1
    torch.cuda.synchronize()
    assert _relerr(y, B.matvec_reference(x)) <= TOL[name]
    assert _relerr(y, A.matvec(x)) <= TOL[name]
    assert not torch.any(y[A.pad_mask() == 0])


def _wide_dia(n, mx, my, seed):
    rng = np.random.default_rng(seed)
    big = mx * my + mx + 1
    rows, cols = [], []
    for o in (-big, -mx * my, -mx, -1, 0, 1, mx, mx * my, big):
        i = np.arange(max(0, -o), min(n, n - o))
        rows.append(i)
        cols.append(i + o)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    order = np.lexsort((cols, rows))
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows[order], minlength=n), out=indptr[1:])
    return CSRMatrix(indptr=indptr, indices=cols[order].astype(np.int64),
                     data=rng.normal(size=rows.size), shape=(n, n))


@pytest.mark.parametrize("storage,name", [("bf16", "float32"),
                                          ("bf16", "float64"),
                                          ("full", "float32"),
                                          ("full", "float64")])
def test_dia_kernel_matches_plain_on_the_heat_operator(cuda_device, storage,
                                                       name):
    _mesh, sy, _dims = _box_system((9, 8, 7), "TETRA4")
    A = dia_from_csr(sy.A, dtype=getattr(torch, name),
                     storage="auto" if storage == "bf16" else "full",
                     device=cuda_device)
    assert (A.data.dtype == torch.bfloat16) == (storage == "bf16")
    x = A.put_vector(np.random.default_rng(22).normal(size=sy.A.n_rows),
                     dtype=getattr(torch, name))
    before = _kernels.DIA_SPMV.launches
    y = A.matvec(x)
    assert _kernels.DIA_SPMV.launches == before + 1
    torch.cuda.synchronize()
    assert _relerr(y, dia_matvec_plain(A, x)) <= TOL[name]


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_dia_kernel_reads_zero_outside_the_vector(cuda_device, name):
    """Offsets of +-(mx*my + mx + 1) on a short matrix: the first and last
    rows read columns outside [0, n_pad) as 0."""
    csr = _wide_dia(700, 9, 7, seed=23)
    A = dia_from_csr(csr, dtype=getattr(torch, name), device=cuda_device)
    x = torch.as_tensor(np.random.default_rng(24).normal(size=A.n_pad),
                        dtype=getattr(torch, name), device=cuda_device)
    y = A.matvec(x)
    torch.cuda.synchronize()
    assert _relerr(y, dia_matvec_plain(A, x)) <= TOL[name]
    ref = csr.matvec(x.double().cpu().numpy()[:700])
    assert np.abs(y.double().cpu().numpy()[:700] - ref).max() <= (
        TOL[name] * np.abs(ref).max())


def test_structured_cli_route_on_the_card_matches_the_cpu(cuda_device,
                                                          tmp_path):
    """The CLI's f64 refinement route on a box with a DIA level 1: the card
    runs the pad-stencil kernel (f32 and f64) and the DIA kernel."""
    from domain_decomposed_pde_solver_tpu_torch.cli.solve import main
    from domain_decomposed_pde_solver_tpu_torch.io import (
        read_nodal_vars,
        write_exodus,
    )

    path = tmp_path / "box.exo"
    write_exodus(str(path), box_mesh(26, 26, 26, elem_type="TETRA4"))
    args = ["--input", str(path), "--dtype", "float64", "--precond", "amg",
            "--no-snapshots", "--tolerance", "1e-8"]
    for k in _kernels.KERNELS:
        k.reset()
    gpu, cpu = {}, {}
    assert main(args + ["--solution", str(tmp_path / "g.exo")], report=gpu) == 0
    by = dict(_kernels.PAD_STENCIL.by_entry)
    assert by["ddps_pad_stencil_f32_bf16"] > 0
    assert by["ddps_pad_stencil_f64_bf16"] > 0
    assert _kernels.DIA_SPMV.launches > 0
    assert main(args + ["--solution", str(tmp_path / "c.exo"), "--cpu"],
                report=cpu) == 0
    assert type(gpu["operator"]).__name__ == "PadStencilOperator"
    assert type(cpu["operator"]).__name__ == "StencilOperator"
    mg, mc = gpu["mixed"], cpu["mixed"]
    assert mg.converged and mc.converged and mg.relres <= 1e-8
    assert mg.refinements == mc.refinements
    assert abs(mg.inner_iterations - mc.inner_iterations) <= mc.refinements
    vg = read_nodal_vars(str(tmp_path / "g.exo"))[2][-1, 0]
    vc = read_nodal_vars(str(tmp_path / "c.exo"))[2][-1, 0]
    assert np.abs(vg - vc).max() <= 1e-6 * np.abs(vc).max()


def test_structured_api_on_the_card_matches_the_cpu(cuda_device):
    mesh = box_mesh(16, 16, 16, elem_type="TETRA4")
    gpu = SteadyHeatSolver(mesh, dtype=torch.float64, precond="jacobi",
                           device=cuda_device)
    cpu = SteadyHeatSolver(mesh, dtype=torch.float64, precond="jacobi",
                           device="cpu")
    assert gpu.operator.data.dtype == torch.bfloat16
    before = _kernels.DIA_SPMV.by_entry["ddps_dia_spmv_bf16_f64"]
    u, r = gpu.solve(tol=1e-10)
    assert _kernels.DIA_SPMV.by_entry["ddps_dia_spmv_bf16_f64"] > before
    c, q = cpu.solve(tol=1e-10)
    assert r.converged and q.converged and r.iterations == q.iterations
    assert np.abs(u - c).max() <= 1e-10 * np.abs(c).max()


def _skewed_csr(n_slices, seed):
    """Square CSR whose 32-row slices have widths 1, 200, 0 (empty) and
    random 1..30, side by side."""
    rng = np.random.default_rng(seed)
    n = n_slices * 32
    lens = np.zeros(n, dtype=np.int64)
    for s in range(n_slices):
        kind = s % 4
        rows = slice(32 * s, 32 * s + 32)
        if kind == 0:
            lens[rows] = 1
        elif kind == 1:
            lens[rows] = rng.integers(150, 201, 32)
            lens[32 * s] = 200
        elif kind == 3:
            lens[rows] = rng.integers(1, 31, 32)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=indptr[1:])
    indices = np.concatenate(
        [np.sort(rng.choice(n, size=k, replace=False)) for k in lens if k]
    )
    return CSRMatrix(indptr=indptr, indices=indices.astype(np.int64),
                     data=rng.normal(size=indices.size), shape=(n, n))


@pytest.mark.parametrize("chunk", [1, 4, 16])
@pytest.mark.parametrize("storage,name", [("float32", "float32"),
                                          ("float32", "float64"),
                                          ("float64", "float64")])
def test_chunked_kernel_matches_plain_on_skewed_slices(cuda_device, chunk,
                                                       storage, name):
    csr = _skewed_csr(96, seed=31)
    A = bsg_from_csr(csr, reorder=False, storage=storage, layout="ragged",
                     chunk=chunk, device=cuda_device)
    D = bsg_from_csr(csr, reorder=False, storage=storage, device=cuda_device)
    assert A.layout == "ragged" and A.chunk == chunk
    x = torch.as_tensor(np.random.default_rng(32).normal(size=A.n_pad),
                        dtype=getattr(torch, name), device=cuda_device)
    before = (_kernels.SELL_CHUNKED_SPMV.launches, _kernels.SELL_SPMV.launches)
    y = bsg_spmv(A, x)
    assert (_kernels.SELL_CHUNKED_SPMV.launches,
            _kernels.SELL_SPMV.launches) == (before[0] + 1, before[1])
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and y.shape == (A.n_pad,)
    assert _relerr(y, spmv_plain(A, x)) <= TOL[name]
    assert _relerr(y, bsg_spmv(D, x)) <= TOL[name]
    empty = np.flatnonzero(np.diff(csr.indptr) == 0)
    assert not torch.any(y[torch.as_tensor(empty, device=cuda_device)])
    assert torch.equal(y, bsg_spmv(A, x))  # deterministic


def _edge_width_csr(chunk, seed):
    """Square CSR whose 32-row slices are, in turn, exactly ``chunk`` wide,
    ``chunk + 1`` wide, empty, ``WARP_CHUNKS * chunk`` wide (the widest a
    warp takes alone), one column more (spread one chunk per warp: a
    transposed transfer's wide rows beside narrow ones) and 1 wide."""
    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import WARP_CHUNKS

    rng = np.random.default_rng(seed)
    kinds = [chunk, chunk + 1, 0, WARP_CHUNKS * chunk, WARP_CHUNKS * chunk + 1,
             1] * 8
    n = 32 * len(kinds)
    lens = np.zeros(n, dtype=np.int64)
    for s, w in enumerate(kinds):
        if w:
            lens[32 * s : 32 * s + 32] = rng.integers(1, w + 1, 32)
            lens[32 * s + rng.integers(32)] = w  # the slice is exactly w wide
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=indptr[1:])
    indices = np.concatenate(
        [np.sort(rng.choice(n, size=k, replace=False)) for k in lens if k]
    )
    return CSRMatrix(indptr=indptr, indices=indices.astype(np.int64),
                     data=rng.normal(size=indices.size), shape=(n, n))


@pytest.mark.parametrize("chunk", [3, 16])
@pytest.mark.parametrize("storage,name", [("float32", "float32"),
                                          ("float32", "float64"),
                                          ("float64", "float64")])
def test_chunked_kernel_on_slice_widths_at_its_edges(cuda_device, chunk,
                                                     storage, name):
    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import WARP_CHUNKS

    csr = _edge_width_csr(chunk, seed=34)
    A = bsg_from_csr(csr, reorder=False, storage=storage, layout="ragged",
                     chunk=chunk, device=cuda_device)
    D = bsg_from_csr(csr, reorder=False, storage=storage, device=cuda_device)
    widths = torch.diff(A.slice_ptr).cpu().numpy() // 32
    per_slice = np.diff(A.chunk_ptr.cpu().numpy())
    np.testing.assert_array_equal(per_slice, -(-widths // chunk))
    assert A.n_slots == D.n_slots
    assert A.wide.numel() == 8 * (WARP_CHUNKS + 1)  # the one-too-wide slices
    x = torch.as_tensor(np.random.default_rng(35).normal(size=A.n_pad),
                        dtype=getattr(torch, name), device=cuda_device)
    before = _kernels.SELL_CHUNKED_SPMV.launches
    y = bsg_spmv(A, x)
    assert _kernels.SELL_CHUNKED_SPMV.launches == before + 1
    torch.cuda.synchronize()
    assert _relerr(y, spmv_plain(A, x)) <= TOL[name]
    assert _relerr(y, bsg_spmv(D, x)) <= TOL[name]
    empty = np.flatnonzero(np.diff(csr.indptr) == 0)
    assert not torch.any(y[torch.as_tensor(empty, device=cuda_device)])
    for _ in range(2):
        assert torch.equal(y, bsg_spmv(A, x))  # bit-identical launches


def test_chunked_kernel_on_the_heat_operator(cuda_device):
    sy = assemble_heat_system(_mesh())
    A = bsg_from_csr(sy.A, layout="ragged", chunk=16, device=cuda_device)
    x = A.put_vector(np.random.default_rng(33).normal(size=sy.A.n_rows))
    y = bsg_spmv(A, x)
    torch.cuda.synchronize()
    ref = sy.A.matvec(A.get_vector(x).astype(np.float64))
    assert np.abs(A.get_vector(y) - ref).max() <= 1e-5 * np.abs(ref).max()


def _laplacian(n, deg, seed, shift=0.5):
    """Random graph Laplacian plus ``shift`` on the diagonal (SPD)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    m = n * deg // 2
    u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = u != v
    u, v = u[keep], v[keep]
    M = sp.coo_matrix((np.ones(2 * u.size), (np.r_[u, v], np.r_[v, u])),
                      shape=(n, n)).tocsr()
    M.data[:] = -1.0
    M.setdiag(0)
    M.eliminate_zeros()
    M.setdiag(-np.asarray(M.sum(axis=1)).ravel() + shift)
    M = M.tocsr()
    M.sort_indices()
    return M


def _fused_case(n, deg, seed, device, shift=0.5):
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        _inverse_diagonal,
    )

    S = _laplacian(n, deg, seed, shift)
    csr = CSRMatrix(indptr=S.indptr.astype(np.int64),
                    indices=S.indices.astype(np.int64), data=S.data,
                    shape=S.shape)
    A = bsg_from_csr(csr, reorder=n < 100_000, device=device)
    x_true = np.random.default_rng(seed + 7).standard_normal(n)
    b_host = (S @ x_true).astype(np.float32)
    return S, A, b_host, A.put_vector(b_host), _inverse_diagonal(A)


@pytest.mark.parametrize("n,deg,seed", [(700, 8, 0), (2500, 14, 1),
                                        (600_000, 6, 2)],
                         ids=["n700", "n2500", "beyond-one-wave"])
def test_fused_cg_kernel_matches_plain(cuda_device, n, deg, seed):
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        fused_cg_plain,
        fused_cg_solve,
    )

    S, A, b_host, b, invd = _fused_case(n, deg, seed, cuda_device)
    before = (_kernels.FUSED_CG.launches, _kernels.SELL_SPMV.launches)
    res = fused_cg_solve(A, b, tol=1e-6, maxiter=500)
    assert (_kernels.FUSED_CG.launches,
            _kernels.SELL_SPMV.launches) == (before[0] + 1, before[1])
    ref = fused_cg_plain(A, b, torch.zeros_like(b), invd, tol=1e-6,
                         maxiter=500)
    assert res.converged and ref.converged
    assert abs(res.iterations - ref.iterations) <= 2
    assert _relerr(res.x, ref.x) <= 1e-4
    x = A.get_vector(res.x).astype(np.float64)
    assert np.linalg.norm(S @ x - b_host) / np.linalg.norm(b_host) < 5e-6
    again = fused_cg_solve(A, b, tol=1e-6, maxiter=500)
    assert again.iterations == res.iterations
    assert torch.equal(again.x, res.x)  # bit-identical


def test_fused_cg_kernel_maxiter_warm_start_and_zero_rhs(cuda_device):
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        fused_cg_solve,
    )

    _S, A, _b_host, b, _invd = _fused_case(500, 8, 3, cuda_device, shift=1e-3)
    capped = fused_cg_solve(A, b, tol=1e-12, maxiter=7)
    assert capped.iterations == 7 and not capped.converged
    done = fused_cg_solve(A, b, tol=1e-6, maxiter=2000)
    warm = fused_cg_solve(A, b, x0=done.x, tol=1e-6, maxiter=2000)
    assert done.converged and warm.iterations == 0 and warm.converged
    zero = fused_cg_solve(A, torch.zeros_like(b), tol=1e-6)
    assert zero.iterations == 0 and zero.converged and zero.relres == 0.0
    assert not torch.any(zero.x)
