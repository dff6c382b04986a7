"""The port on the card: the hand-written kernels (sliced-ELL SpMV,
pad-stencil, DIA, chunked sliced-ELL SpMV, fused Jacobi-PCG) against their
plain PyTorch versions, and the solves through them against the same
solves on the CPU; also the one sliced-ELL launch over all parts of the
partitioned operator (``parallel.BSGShardedOperator``) against each
part's block alone, the AMG restrictions' fixed-order segment sums and
the halo AMG's bits over runs and processes, partitioned Jacobi-CG on
the card against the CPU's iterations, and the pad-stencil kernel on the
windows of a z-slab split (``parallel.build_slab_pad_stencil``) with the
slab-pad AMG solve on the card against the CPU's iterations; two
processes sharing the card over gloo (``chip_smoke.py`` phase J at a
small size), and the CLI's ``--partitions`` routes run by two processes
on the card (phase M at a small size); and, with two processes emulated
by threads, each part's sums, products and solves on a process holding k
of P parts against one process holding all P, bit for bit.

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
VALUES = ("i8", "bf16", "f32")  # the value storages of kernels 1, 2 and 5
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


def _random_dia(n, offsets, storage, vector, device, seed):
    """A DIA operator on ``offsets`` with random coefficients everywhere,
    also where the column falls outside [0, n) (the kernel reads x as 0
    there)."""
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import DIAMatrix

    rng = np.random.default_rng(seed)
    data = torch.as_tensor(rng.normal(size=(len(offsets), n)))
    compute = "" if storage == vector else vector
    return DIAMatrix(data=data.to(getattr(torch, storage)).to(device),
                     offsets=tuple(int(o) for o in offsets), n_rows=n,
                     compute_dtype=compute)


def _dia_case(case, device):
    if case in ("level1", "hex8", "pathB"):
        shape, elem, name, storage = {
            "level1": ((16, 16, 19), "TETRA4", "float32", "full"),
            "hex8": ((12, 12, 12), "HEX8", "float32", "full"),
            "pathB": ((20, 20, 20), "TETRA4", "float64", "auto"),
        }[case]
        _mesh, sy, _dims = _box_system(shape, elem)
        A = dia_from_csr(sy.A, dtype=getattr(torch, name), storage=storage,
                         device=device)
        return A, name
    rng = np.random.default_rng(31)
    if case == "edge19":  # fewer rows than a block; offsets past both ends
        offs = np.r_[0, rng.choice(np.r_[-80:0, 1:81], 18, replace=False)]
        return _random_dia(40, np.sort(offs), "float32", "float32", device,
                           32), "float32"
    if case in ("inst23", "loop7"):  # 23: an instance; 7: the run-time loop
        nd = 23 if case == "inst23" else 7
        offs = np.sort(rng.choice(np.arange(-700, 701), nd, replace=False))
        return _random_dia(5003, offs, "float32", "float64", device,
                           33), "float64"
    # 1M rows, the box's 19 offsets, bf16 storage with f64 vectors
    m = 101
    offs = sorted({0, 1, -1, m, -m, m * m, -m * m, m + 1, -m - 1, m * m + 1,
                   -m * m - 1, m * m + m, -m * m - m, m * m + m + 1,
                   -m * m - m - 1, m - 1, 1 - m, m * m - m, m - m * m})
    return _random_dia(1_000_000, offs, "bfloat16", "float64", device,
                       34), "float64"


@pytest.mark.parametrize("case", ["level1", "hex8", "pathB", "edge19",
                                  "inst23", "loop7", "1M"])
def test_dia_kernel_every_instance_and_shape_bit_identical(cuda_device, case):
    """Every compiled instance (19, 23, 27), the run-time loop and every block
    (32 to 256 threads) add a row's products in the same order:
    bit-identical to the default launch, and each within the f32/f64
    tolerance of the plain version."""
    A, name = _dia_case(case, cuda_device)
    x = torch.as_tensor(np.random.default_rng(35).normal(size=A.n_pad),
                        dtype=getattr(torch, name), device=cuda_device)
    default = _kernels.dia_launch_shape(A.n_pad, A.ndiags)
    assert default.instance == (A.ndiags if A.ndiags in (19, 23, 27) else 0)
    assert A.ndiags == {"level1": 19, "hex8": 27, "pathB": 19, "edge19": 19,
                        "inst23": 23, "loop7": 7, "1M": 19}[case]
    before = _kernels.DIA_SPMV.launches
    y0 = A.matvec(x)
    assert _kernels.DIA_SPMV.launches == before + 1
    torch.cuda.synchronize()
    assert _relerr(y0, dia_matvec_plain(A, x)) <= TOL[name]
    for instance in sorted({default.instance, 0}):
        for block in _kernels.DIA_BLOCKS:
            shape = _kernels.DiaLaunch(instance, block)
            y = _kernels.dia_spmv_launch(A.data, A.offsets_array, x,
                                         shape=shape)
            torch.cuda.synchronize()
            assert torch.equal(y, y0), shape


def test_dia_floor_entries_launch(cuda_device):
    x = torch.ones(4920, device=cuda_device)
    before = _kernels.DIA_SPMV.by_entry["ddps_dia_floor_copy_f32"]
    for kind in ("noop", "copy"):
        _kernels.dia_floor_launch(kind, x, _kernels.DiaLaunch(0, 64))
    torch.cuda.synchronize()
    assert _kernels.DIA_SPMV.by_entry["ddps_dia_floor_copy_f32"] == before + 1
    with pytest.raises(ValueError):
        _kernels.dia_floor_launch("copy", x, _kernels.DiaLaunch(0, 48))


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


def _check_restart(S, b_host, A, b, done, invd):
    """Restart ``fused_cg_solve`` from its converged iterate ``done.x`` and
    hold it against the plain recurrence restarted from the same iterate.
    Both start from the true residual b - A x0 in f32, which the recursive
    residual that stopped ``done`` never saw: where the iterate's host
    relres lies at the tolerance, rounding decides whether the restart
    stops at once, so it converges within one iteration of the plain one;
    where it lies below the tolerance by more than the f32 rounding floor
    (eps/2 * || |A| |x| || / ||b||, four times over), it stops at once."""
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        fused_cg_plain,
        fused_cg_solve,
    )

    warm = fused_cg_solve(A, b, x0=done.x, tol=1e-6, maxiter=2000)
    plain = fused_cg_plain(A, b, done.x, invd, tol=1e-6, maxiter=2000)
    assert done.converged and warm.converged and plain.converged
    assert warm.iterations <= plain.iterations + 1
    x = A.get_vector(done.x).astype(np.float64)
    bh = np.asarray(b_host, dtype=np.float64)
    host = np.linalg.norm(S @ x - bh) / np.linalg.norm(bh)
    floor = (np.finfo(np.float32).eps / 2
             * np.linalg.norm(abs(S) @ np.abs(x)) / np.linalg.norm(bh))
    assert host < 5e-6
    if host + 4 * floor <= 1e-6:
        assert warm.iterations == 0 and torch.equal(warm.x, done.x)
    return warm


def test_fused_cg_kernel_maxiter_warm_start_and_zero_rhs(cuda_device):
    """``fused_cg_solve`` on a 500-node graph of 1,024 padded rows (the
    cluster instance): capped, restarted from its converged iterate, and
    on a zero right side."""
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        fused_cg_solve,
    )

    S, A, b_host, b, invd = _fused_case(500, 8, 3, cuda_device, shift=1e-3)
    capped = fused_cg_solve(A, b, tol=1e-12, maxiter=7)
    assert capped.iterations == 7 and not capped.converged
    done = fused_cg_solve(A, b, tol=1e-6, maxiter=2000)
    _check_restart(S, b_host, A, b, done, invd)
    zero = fused_cg_solve(A, torch.zeros_like(b), tol=1e-6)
    assert zero.iterations == 0 and zero.converged and zero.relres == 0.0
    assert not torch.any(zero.x)


def _refined_operator(cells, device):
    sy = assemble_heat_system(refine_uniform(box_mesh(cells, cells, cells,
                                                      elem_type="TETRA4"), 1))
    A = bsg_from_csr(sy.A, device=device)
    return sy, A, A.put_vector(sy.b)


def _entries():
    """Launches of the cluster instance and of the grid instance, over the
    entries of every value storage (a refined box's Laplacian stores
    int8)."""
    by = _kernels.FUSED_CG.by_entry
    return tuple(sum(by[f"ddps_fused_cg{base}_{v}"] for v in VALUES)
                 for base in ("_cluster", ""))


@pytest.mark.parametrize("cells,n_pad", [(5, 1024), (10, 8192), (13, 16384)])
def test_fused_cg_cluster_instance_matches_plain(cuda_device, cells, n_pad):
    """Refined boxes of 1, 8 and 16 CTAs (964, 7,379 and 16,028 DOF) take
    the cluster instance: one launch of its entry, none of the grid's."""
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        _inverse_diagonal,
        fused_cg_plain,
        fused_cg_plan,
        fused_cg_solve,
    )

    _sy, A, b = _refined_operator(cells, cuda_device)
    assert A.n_pad == n_pad and fused_cg_plan(A).instance == "cluster"
    before = _entries()
    res = fused_cg_solve(A, b, tol=1e-6, maxiter=2000)
    assert _entries() == (before[0] + 1, before[1])
    ref = fused_cg_plain(A, b, torch.zeros_like(b), _inverse_diagonal(A),
                         tol=1e-6, maxiter=2000)
    assert res.converged and ref.converged
    assert abs(res.iterations - ref.iterations) <= 2
    assert _relerr(res.x, ref.x) <= 1e-4
    again = fused_cg_solve(A, b, tol=1e-6, maxiter=2000)
    assert again.iterations == res.iterations
    assert torch.equal(again.x, res.x)  # bit-identical


def test_fused_cg_cluster_zero_rhs_maxiter_and_warm_start(cuda_device):
    """The cluster instance on a refined box of 8 CTAs: b = 0, maxiter = 0
    keeps x0, maxiter caps the solve, and a restart from the converged
    iterate (``_check_restart``); also the restart on the 600-node graph of
    JAX's ``test_fused_warm_start``."""
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        _inverse_diagonal,
        fused_cg_plan,
        fused_cg_solve,
    )

    sy, A, b = _refined_operator(10, cuda_device)
    assert fused_cg_plan(A).instance == "cluster"
    zero = fused_cg_solve(A, torch.zeros_like(b), tol=1e-6)
    assert zero.iterations == 0 and zero.converged and zero.relres == 0.0
    assert not torch.any(zero.x)
    x0 = torch.linspace(-1.0, 1.0, A.n_pad, device=cuda_device)
    none = fused_cg_solve(A, b, x0=x0, tol=1e-6, maxiter=0)
    assert none.iterations == 0 and not none.converged
    assert torch.equal(none.x, x0)
    done = fused_cg_solve(A, b, tol=1e-6, maxiter=2000)
    _check_restart(sy.A.to_scipy(), sy.b, A, b, done, _inverse_diagonal(A))
    capped = fused_cg_solve(A, b, tol=1e-12, maxiter=7)
    assert capped.iterations == 7 and not capped.converged
    G_host, G, bg_host, bg, invd = _fused_case(600, 9, 5, cuda_device)
    assert fused_cg_plan(G).instance == "cluster"
    done = fused_cg_solve(G, bg, tol=1e-6, maxiter=2000)
    warm = _check_restart(G_host, bg_host, G, bg, done, invd)
    assert warm.iterations == 0  # its iterate lies far inside the tolerance


def test_fused_cg_past_the_cluster_takes_the_grid(cuda_device):
    """16,385 rows pad to 17 CTAs: the grid instance, launched once."""
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        fused_cg_plan,
        fused_cg_solve,
    )

    _S, A, _b_host, b, _invd = _fused_case(16_385, 6, 4, cuda_device)
    assert A.n_pad == 17_408 and fused_cg_plan(A).instance == "grid"
    before = _entries()
    res = fused_cg_solve(A, b, tol=1e-6, maxiter=2000)
    assert _entries() == (before[0], before[1] + 1)
    assert res.converged


def test_resumed_cg_on_the_card_is_bit_identical(cuda_device, tmp_path):
    """The resumable CG on the card's DIA kernel (bf16 storage, f64
    vectors): stopped at 30 iterations and resumed from its checkpoint, it
    takes the unbroken run's iterations and lands on its answer bit for
    bit; both answers agree with the same solve on the CPU to 1e-10."""
    from domain_decomposed_pde_solver_tpu_torch.solvers import (
        cg_solve_resumable,
        jacobi_preconditioner,
    )

    sy = assemble_heat_system(box_mesh(14, 13, 12, elem_type="TETRA4"))

    def solve(device, path, maxiter=2000):
        A = choose_operator(sy.A, dtype=torch.float64, device=device)
        b = A.put_vector(sy.b)
        return cg_solve_resumable(
            A, b, torch.zeros_like(b), checkpoint_path=str(path),
            checkpoint_every=10, precond=jacobi_preconditioner(A), tol=1e-10,
            maxiter=maxiter)

    before = _kernels.DIA_SPMV.by_entry["ddps_dia_spmv_bf16_f64"]
    whole = solve(cuda_device, tmp_path / "whole.npz")
    assert _kernels.DIA_SPMV.by_entry["ddps_dia_spmv_bf16_f64"] > before
    first = solve(cuda_device, tmp_path / "broken.npz", maxiter=30)
    assert first.iterations == 30 and not first.converged
    rest = solve(cuda_device, tmp_path / "broken.npz")
    assert whole.converged and rest.iterations == whole.iterations
    assert torch.equal(rest.x, whole.x)
    cpu = solve("cpu", tmp_path / "cpu.npz")
    assert abs(cpu.iterations - whole.iterations) <= 1
    assert _relerr(whole.x, cpu.x) <= 1e-10


def test_transient_step_on_the_card_matches_plain(cuda_device):
    """One implicit-Euler step of the transient model on the DIA kernel
    against the same step through the kernel's plain version (the CPU):
    CG to 1e-12 on both, iterations within one, states within 1e-10."""
    from domain_decomposed_pde_solver_tpu_torch.models import (
        transient_heat_solve,
    )

    sy = assemble_heat_system(box_mesh(16, 16, 16, elem_type="TETRA4"))
    u0 = np.random.default_rng(6).uniform(0.0, 1000.0, size=sy.n_free)
    out = {}
    for dev in (cuda_device, "cpu"):
        A = choose_operator(sy.A, dtype=torch.float64, device=dev)
        before = _kernels.DIA_SPMV.launches
        out[str(dev)] = transient_heat_solve(sy, A, dt=0.2, n_steps=1, u0=u0,
                                             tol=1e-12)
        launched = _kernels.DIA_SPMV.launches - before
        assert (launched > 0) == (A.device.type == "cuda")
    g, c = out[str(cuda_device)], out["cpu"]
    assert abs(g.total_cg_iterations - c.total_cg_iterations) <= 1
    assert np.abs(g.u - c.u).max() <= 1e-10 * np.abs(c.u).max()


# -- int8 and bfloat16 values (kernels 1, 2 and 5) ---------------------------


def _value_matrices():
    """name -> (scipy CSR, its narrowest exact storage): the graph Laplacian
    of a refined box and a random matrix of every integer in [-127, 127]
    (int8), a shifted random Laplacian (bfloat16) and a matrix of neither
    (float32)."""
    import scipy.sparse as sp

    sy = assemble_heat_system(_mesh())
    S = sp.csr_matrix((sy.A.data, sy.A.indices, sy.A.indptr),
                      shape=sy.A.shape)
    rng = np.random.default_rng(7)
    R = sp.random(2000, 2000, density=0.01, random_state=7, format="csr")
    R.data = rng.integers(-127, 128, R.data.size).astype(np.float64)
    R.data[:255] = np.arange(-127, 128)  # every value
    R.sort_indices()
    G = _laplacian(900, 8, 7)
    G.data = G.data * (1.0 + 0.01 * rng.random(G.data.size))
    G = ((G + G.T) * 0.5).tocsr()
    G.sort_indices()
    return {"laplacian": (S, "int8"), "int8_range": (R, "int8"),
            "bf16_exact": (_laplacian(900, 8, 1), "bfloat16"),
            "general": (G, "float32")}


def _csr(S):
    return CSRMatrix(indptr=S.indptr.astype(np.int64),
                     indices=S.indices.astype(np.int64),
                     data=S.data.astype(np.float64), shape=S.shape)


EXACT = {"int8": ("int8", "bfloat16", "float32"),
         "bfloat16": ("bfloat16", "float32"), "float32": ("float32",)}


@pytest.mark.parametrize("layout", ["dense", "ragged"])
@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["laplacian", "int8_range", "bf16_exact",
                                  "general"])
def test_value_storages_match_plain_and_float32(cuda_device, kind, name,
                                                layout):
    """Kernel 1 (dense layout) and kernel 2 (ragged, chunk 16) with every
    storage that holds the operator's values exactly: each within the
    tolerance of its plain version, and each bit-identical to the float32
    storage's launch (the values convert exactly before their products)."""
    S, narrow = _value_matrices()[kind]
    csr = _csr(S)
    kernel = _kernels.SELL_SPMV if layout == "dense" else \
        _kernels.SELL_CHUNKED_SPMV
    ops = {s: bsg_from_csr(csr, storage=s, layout=layout, device=cuda_device)
           for s in EXACT[narrow]}
    assert bsg_from_csr(csr, device=cuda_device).storage == narrow  # "auto"
    x = ops["float32"].put_vector(
        np.random.default_rng(41).normal(size=csr.n_rows),
        dtype=getattr(torch, name))
    ys = {}
    for s, A in ops.items():
        entry = (f"ddps_sell_{'' if layout == 'dense' else 'chunked_'}spmv_"
                 f"{_kernels._NAME[A.vals.dtype]}_{_kernels._NAME[x.dtype]}")
        before = kernel.by_entry[entry]
        ys[s] = bsg_spmv(A, x)
        assert kernel.by_entry[entry] == before + 1
        torch.cuda.synchronize()
        assert _relerr(ys[s], spmv_plain(A, x)) <= TOL[name]
    for s in ops:
        assert torch.equal(ys[s], ys["float32"]), s


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["laplacian", "int8_range", "bf16_exact",
                                  "general"])
def test_sell_operator_every_storage_matches_plain(cuda_device, kind, name):
    """Kernel 1 on an operator packed by ``sell_operator`` (rows as given,
    a row count that is not a multiple of 32, padding slots past the
    input) in every value storage that holds the operator exactly, and in
    float64 storage with f64 vectors: each launch within the tolerance of
    its plain version, bit for bit the ``bsg_from_csr`` pack's launch of
    the same storage on its real rows and, for the storages that hold the
    operator exactly, the float32 storage's launch."""
    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import sell_operator

    S, narrow = _value_matrices()[kind]
    csr = _csr(S)
    n = csr.n_rows - 5  # drop the last rows: n is not a multiple of 32
    storages = EXACT[narrow] + (("float64",) if name == "float64" else ())
    x = None
    ys = {}
    for s in storages:
        A = bsg_from_csr(csr, storage=s, reorder=False, device=cuda_device)
        O = sell_operator(csr.indptr[: n + 1], csr.indices[: csr.indptr[n]],
                          csr.data[: csr.indptr[n]], A.n_pad, storage=s,
                          device=cuda_device)
        assert O.n_pad == n and n % 32 and O.storage == A.storage
        if x is None:
            x = A.put_vector(np.random.default_rng(43).normal(
                size=csr.n_rows), dtype=getattr(torch, name))
        before = _kernels.SELL_SPMV.launches
        ys[s] = bsg_spmv(O, x)
        assert _kernels.SELL_SPMV.launches == before + 1
        torch.cuda.synchronize()
        assert _relerr(ys[s], spmv_plain(O, x)) <= TOL[name]
        assert torch.equal(ys[s], bsg_spmv(A, x)[:n]), s
    for s in EXACT[narrow]:
        assert torch.equal(ys[s], ys["float32"]), s


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("split", [False, True])
def test_segment_sum_on_the_card_equals_its_plain_version_on_the_cpu(
        cuda_device, split, name):
    """The AMG restrictions' segment sum on kernel 1 gives the bits of its
    plain version on the CPU, on every run (a scatter-add on the card
    would add with atomics): in one launch where every segment is one
    thread's (then ``index_add_``'s bits), and in pieces then segments
    where segments are wider than the width (aggregates of ~300 rows)."""
    from domain_decomposed_pde_solver_tpu_torch.ops.bsg import (
        segment_sum_operator,
    )

    rng = np.random.default_rng(8)
    n, n_seg = 200_000, (700 if split else 9_000)
    seg = rng.integers(0, n_seg, n)
    valid = rng.random(n) < 0.95
    dt = getattr(torch, name)
    x = torch.as_tensor(rng.normal(size=n), dtype=dt)
    width = 32 if split else n
    S = segment_sum_operator(seg, n_seg, valid=valid, width=width,
                             device=cuda_device)
    assert (S.total is not None) == split
    want = segment_sum_operator(seg, n_seg, valid=valid, width=width,
                                device="cpu").matvec(x)
    if not split:
        assert torch.equal(want, torch.zeros(n_seg, dtype=dt).index_add_(
            0, torch.as_tensor(seg[valid]), x[torch.as_tensor(valid)]))
    xd = x.to(cuda_device)
    for _ in range(2):
        assert torch.equal(S.matvec(xd).cpu(), want)


@pytest.mark.parametrize("case", ["cluster", "grid"])
def test_fused_cg_int8_values_match_float32_bit_for_bit(cuda_device, case):
    """Kernel 5 on the int8 values ``storage="auto"`` keeps for a graph
    Laplacian: the float32-stored copy's iterations and answer, bit for
    bit, in both instances (a refined 13^3 box, 16,384 rows: the cluster
    instance through ``fused_cg_solve``, the grid instance launched on the
    same operator)."""
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        fused_cg_plan,
        fused_cg_solve,
    )

    sy, A, b = _refined_operator(13, cuda_device)
    F = bsg_from_csr(sy.A, storage="float32", device=cuda_device)
    assert A.storage == "int8"
    assert fused_cg_plan(A).instance == fused_cg_plan(F).instance == "cluster"
    by = _kernels.FUSED_CG.by_entry
    base = "_cluster" if case == "cluster" else ""
    before = by[f"ddps_fused_cg{base}_i8"]

    def solve(op):
        if case == "cluster":
            r = fused_cg_solve(op, b, tol=1e-6, maxiter=2000)
            return r.x, r.iterations
        x, stats = _kernels.fused_cg_launch(
            op.slice_ptr, op.cols, op.vals, b, fused_cg_plan(op).invd,
            torch.zeros_like(b), 1e-6, 2000)
        return x, int(stats[0].item())

    xi, ki = solve(A)
    assert by[f"ddps_fused_cg{base}_i8"] == before + 1
    xf, kf = solve(F)
    assert 0 < ki < 2000 and ki == kf
    assert torch.equal(xi, xf)


def test_fused_cg_bfloat16_values_match_plain(cuda_device):
    """A shifted random Laplacian stores bfloat16; 2,500 rows (3,072
    padded) take the cluster instance."""
    from domain_decomposed_pde_solver_tpu_torch.solvers.fused_cg import (
        fused_cg_plain,
        fused_cg_plan,
        fused_cg_solve,
    )

    S, A, b_host, b, invd = _fused_case(2500, 14, 1, cuda_device)
    assert A.storage == "bfloat16" and fused_cg_plan(A).instance == "cluster"
    before = _kernels.FUSED_CG.by_entry["ddps_fused_cg_cluster_bf16"]
    res = fused_cg_solve(A, b, tol=1e-6, maxiter=500)
    assert _kernels.FUSED_CG.by_entry["ddps_fused_cg_cluster_bf16"] == \
        before + 1
    ref = fused_cg_plain(A, b, torch.zeros_like(b), invd, tol=1e-6,
                         maxiter=500)
    assert res.converged and abs(res.iterations - ref.iterations) <= 2
    assert _relerr(res.x, ref.x) <= 1e-4
    F = bsg_from_csr(_csr(S), storage="float32", device=cuda_device)
    rf = fused_cg_solve(F, F.put_vector(b_host), tol=1e-6, maxiter=500)
    assert rf.iterations == res.iterations and torch.equal(rf.x, res.x)


def test_structured_parts_on_the_card_equal_numpy(cuda_device):
    """``structured_box_parts(device=True)`` builds corr, b and degree on
    the card, bit for bit the numpy build; the pad-stencil operator from
    them is the one from the numpy parts."""
    from domain_decomposed_pde_solver_tpu_torch.models.structured import (
        structured_box_parts,
        structured_box_system,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        pad_stencil_from_parts,
    )

    on = structured_box_parts(16, 10, 12, device=True)
    host = structured_box_parts(16, 10, 12)
    for k in ("b", "degree"):
        assert on[k].device == cuda_device
        np.testing.assert_array_equal(on[k].cpu().numpy(), host[k])
    np.testing.assert_array_equal(on["parts"]["corr_pad"].cpu().numpy(),
                                  host["parts"]["corr_pad"])
    A = pad_stencil_from_parts(on["parts"], device=cuda_device)
    B = pad_stencil_from_parts(host["parts"], device=cuda_device)
    assert torch.equal(A.corr, B.corr)
    sy = structured_box_system(16, 10, 12)
    x = np.random.default_rng(43).normal(size=sy.n_free)
    y = A.get_vector(A.matvec(A.put_vector(x, dtype=torch.float64)))
    ref = sy.A.matvec(x)
    assert np.abs(y - ref).max() <= TOL["float64"] * np.abs(ref).max()



def _partitioned(nparts, device, dtype=np.float32, op="bsg"):
    """The refined 8^3 box over ``nparts`` parts (the CLI's partition), as
    a partitioned operator on ``device``."""
    from domain_decomposed_pde_solver_tpu_torch.ops.csr import coo_to_csr
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        BSGShardedOperator,
        ShardedOperator,
        build_halo_plan,
        make_device_mesh,
        partition_graph,
    )

    sy = assemble_heat_system(_mesh())
    A = sy.A
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    off = rows != A.indices
    adj = coo_to_csr(rows[off], A.indices[off], np.ones(int(off.sum())),
                     A.shape, sum_dups=False)
    parts = partition_graph(adj, nparts,
                            coords=sy.mesh.coords[sy.free_to_node])
    plan = build_halo_plan(A, parts, nparts, dtype=dtype)
    cls = BSGShardedOperator if op == "bsg" else ShardedOperator
    return sy, cls.from_plan(plan, make_device_mesh(nparts, [device]))


@pytest.mark.parametrize("nparts", [2, 4, 8])
def test_sharded_parts_match_plain(cuda_device, nparts):
    """``BSGShardedOperator``'s product is one kernel-1 launch over all
    parts (the stacked operator): against its plain version (relative 1e-6
    in f32), and bit for bit each part's rows of the same kernel on that
    part's block alone, whose halo rows past ``n_local`` are exactly 0 and
    which matches its own plain version; the partitioned product is the
    host CSR's."""
    sy, op = _partitioned(nparts, cuda_device)
    rng = np.random.default_rng(nparts)
    x = torch.as_tensor(rng.normal(size=(nparts, op.n_local)),
                        dtype=torch.float32, device=cuda_device)
    before = _kernels.SELL_SPMV.launches
    y = op.matvec(x)
    assert _kernels.SELL_SPMV.launches == before + 1
    torch.cuda.synchronize()
    assert y.shape == x.shape and op.local.storage == "bfloat16"
    assert _relerr(y, spmv_plain(op.local, op.source(x)).view_as(y)) <= 1e-6
    xe = op.extended(x)
    for p, blk in enumerate(op.parts):
        assert blk.storage == "bfloat16"
        yp = bsg_spmv(blk, xe[p])
        torch.cuda.synchronize()
        assert torch.equal(y[p], yp[:op.n_local]), p
        assert _relerr(yp, spmv_plain(blk, xe[p])) <= TOL["float32"]
        assert not yp[op.n_local:].any()
    before = _kernels.SELL_SPMV.launches
    xg = rng.normal(size=sy.n_free)
    y = op.get_vector(op.matvec(op.put_vector(xg)))
    assert _kernels.SELL_SPMV.launches == before + 1
    ref = sy.A.matvec(xg)
    assert np.abs(y - ref).max() <= TOL["float32"] * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["bsg", "ell"])
def test_sharded_jacobi_cg_on_the_card_matches_cpu(cuda_device, kind):
    """Partitioned Jacobi-CG in f32 to 1e-6 on the card (kernel 1 over all
    parts for the sliced-ELL blocks) takes the CPU port's iterations
    within 1."""
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        sharded_cg_solve,
    )

    its = []
    for dev in (cuda_device, torch.device("cpu")):
        sy, op = _partitioned(4, dev, op=kind)
        b = op.put_vector(sy.b)
        inv_d = op.put_vector(1.0 / np.where(sy.degree > 0, sy.degree, 1.0))
        res = sharded_cg_solve(op, b, torch.zeros_like(b), precond_diag=inv_d,
                               tol=1e-6, maxiter=2000)
        assert res.converged
        its.append(res.iterations)
    assert abs(its[0] - its[1]) <= 1


def _slab_pad_plan(device, corr="auto", nparts=4):
    """The z-slab plan of a pad-stencil operator on ``device``: free grid
    9 x 9 x 19 at bz = 4 over 4 parts, slabs of 6, 6, 6 and 1 real layers
    (the last slab has 5 dead layers)."""
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        pad_stencil_from_stencil,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        build_slab_pad_stencil,
    )

    _mesh, sy, dims = _box_system((10, 8, 18), "TETRA4")
    st = choose_operator(sy.A, dtype=torch.float32, grid_dims=dims,
                         device=device)
    A = pad_stencil_from_stencil(st, bz=4, corr_storage=corr)
    return sy, A, build_slab_pad_stencil(A, nparts)


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("part", [1, 3], ids=["interior", "last"])
def test_pad_window_launch_matches_plain(cuda_device, name, part):
    """Kernel 3 on one slab's window (its halo layers in the guard slots,
    Z = L + 2, mz the slab's last real layer) against its plain version on
    the same window; the guard layers, the last slab's dead layers and
    every pad slot exactly 0; the slab product over all parts is the
    single-device product."""
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        pad_window_reference,
    )

    sy, A, plan = _slab_pad_plan(cuda_device)
    op = plan.make_ops()
    assert plan.L == 6 and op.zlim == (6, 6, 6, 1)
    dt = getattr(torch, name)
    xg = np.random.default_rng(part).normal(size=sy.n_free)
    x = plan.put_vector(xg, dtype=np.dtype(name))
    xe = op.extended(x)
    before = _kernels.PAD_STENCIL.by_form.get("window", 0)
    y = _kernels.pad_stencil_window_launch(op, xe[part], op.corr_ext[part],
                                           op.zlim[part])
    torch.cuda.synchronize()
    assert _kernels.PAD_STENCIL.by_form["window"] == before + 1
    assert y.dtype == dt
    ref = pad_window_reference(op, xe[part], op.corr_ext[part], op.zlim[part])
    assert _relerr(y, ref) <= TOL[name]
    live = torch.zeros(plan.L + 2, op.myp, op.mxp, dtype=torch.bool,
                       device=cuda_device)
    live[1: op.zlim[part] + 1, 1: A.dims[1] + 1, : A.dims[0]] = True
    assert not y.reshape(live.shape)[~live].any()
    y_all = op.matvec(x)
    y1 = A.get_vector(A.matvec(A.put_vector(xg, dtype=dt)))
    assert np.abs(plan.gather_vector(y_all) - y1).max() <= TOL[name] * (
        np.abs(y1).max())


def test_pad_window_bf16_correction_is_bit_identical(cuda_device):
    """A window with the bfloat16 correction gives the bits of a float32
    launch of the same (bf16-exact) values."""
    _sy, A, plan = _slab_pad_plan(cuda_device)
    op = plan.make_ops()
    assert op.corr_ext.dtype == torch.bfloat16
    x = torch.randn(op.nparts, op.n_pad, device=cuda_device)
    x = x * plan.put_vector(np.ones(int(np.prod(A.dims)), np.float32))
    xe = op.extended(x)
    for p in range(op.nparts):
        c16 = op.corr_ext[p]
        y16 = _kernels.pad_stencil_window_launch(op, xe[p], c16, op.zlim[p])
        y32 = _kernels.pad_stencil_window_launch(op, xe[p], c16.float(),
                                                 op.zlim[p])
        assert torch.equal(y16, y32)


def test_slab_pad_amg_on_the_card_matches_cpu(cuda_device):
    """The slab-pad AMG solve in f32 to 1e-6 on the card (kernel 3 on
    every window) takes the CPU port's iterations within 1; every kernel-3
    launch of the solve is a window launch."""
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        pad_stencil_from_stencil,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        build_slab_pad_amg,
        slab_pad_amg_cg_solve,
    )

    _mesh, sy, dims = _box_system((8, 6, 20), "TETRA4")  # 7 x 7 x 21
    its = []
    for dev in (cuda_device, torch.device("cpu")):
        st = choose_operator(sy.A, dtype=torch.float32, grid_dims=dims,
                             device=dev)
        pad_op = pad_stencil_from_stencil(st, bz=4)  # 6-layer slabs
        samg = build_slab_pad_amg(sy.A, dims, 4, pad_op=pad_op)
        assert samg.plan.L == 6 and samg.plan.device.type == dev.type
        _kernels.PAD_STENCIL.reset()
        x, res = slab_pad_amg_cg_solve(samg, sy.b, np.zeros(sy.n_free),
                                       tol=1e-6)
        assert res.converged and np.isfinite(x).all()
        its.append(res.iterations)
        if dev.type == "cuda":
            k = _kernels.PAD_STENCIL
            assert k.launches > 0 and k.by_form["window"] == k.launches
    assert abs(its[0] - its[1]) <= 1


def test_structured_partitions_cli_f32_takes_the_slab_pad_amg(cuda_device,
                                                              tmp_path):
    """The CLI's first structured ``--partitions`` branch: f32 on the card
    takes the slab-pad AMG (JAX: on a TPU), kernel 3 runs only on slab
    windows, the iterations are the CPU API solve's within 1, and the
    solution file holds the boundary snapshot and the answer."""
    from domain_decomposed_pde_solver_tpu_torch.cli.solve import main
    from domain_decomposed_pde_solver_tpu_torch.io import (
        read_nodal_vars,
        write_exodus,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        SlabPadAMG,
        build_slab_pad_amg,
        slab_pad_amg_cg_solve,
    )

    mesh = box_mesh(8, 6, 30, elem_type="TETRA4")  # free 7 x 7 x 31
    path = tmp_path / "box.exo"
    write_exodus(str(path), mesh)
    _kernels.PAD_STENCIL.reset()
    rep = {}
    assert main(["--input", str(path), "--solution", str(tmp_path / "g.exo"),
                 "--partitions", "2", "--precond", "amg", "--dtype",
                 "float32", "--tolerance", "1e-6"], report=rep) == 0
    k = _kernels.PAD_STENCIL
    assert isinstance(rep["precond"], SlabPadAMG)
    assert rep["precond"].device.type == "cuda" and rep["precond"].plan.L == 30
    assert k.launches > 0 and k.by_form["window"] == k.launches
    res = rep["result"]
    assert res.converged

    sy = assemble_heat_system(mesh)
    dims = infer_free_grid(mesh, sy.free_to_node)
    samg = build_slab_pad_amg(sy.A, dims, 2, device="cpu")
    x, r = slab_pad_amg_cg_solve(samg, sy.b.astype(np.float32),
                                 np.zeros(sy.n_free, np.float32), tol=1e-6)
    assert r.converged and abs(res.iterations - r.iterations) <= 1

    _names, _times, vals = read_nodal_vars(str(tmp_path / "g.exo"))
    assert vals.shape[0] >= 2  # the boundary snapshot, then the answer
    u = vals[-1, 0, sy.free_to_node]
    assert np.isfinite(u).all() and 99 <= u.min() <= u.max() <= 1001
    assert np.abs(u - x).max() <= 1e-4 * np.abs(x).max()


def test_smoke_timing_falls_back_to_events_without_a_trace(cuda_device,
                                                           monkeypatch):
    """``chip_smoke.py``'s timing helpers, given a profiler that hands back
    no device events, time the same calls with CUDA events and mark what
    they could not measure."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "_device_events", lambda prof: [])
    x = torch.ones(1 << 20, device=cuda_device)

    def fn():
        x.mul_(1.0)

    p = chip_smoke.profile_device(fn, reps=3, kernel="k", attempts=2)
    assert p["timed_by"] == "events" and p["device_ms"] > 0
    assert p["busy_ms"] is None and p["kernels"] == {}
    rec = chip_smoke.replay_record(p)
    assert rec["idle_share"] is None
    assert "not measured" in chip_smoke.replay_text(rec)
    scrub = torch.empty(1 << 20, device=cuda_device)
    assert chip_smoke.profile_cold(fn, scrub, "k", reps=3, attempts=2) > 0

    class Op:
        nparts = 2

        @staticmethod
        def matvec(v):
            return v * 2.0

    ms = chip_smoke._per_part_ms(Op(), x, [fn, fn], reps=3, attempts=2)
    assert len(ms) == 2 and all(m > 0 for m in ms)


def test_two_processes_share_the_card_over_gloo(cuda_device, tmp_path):
    """``chip_smoke.py`` phase J at a small size: two worker processes on
    the card over gloo (every collective staged through host memory), the
    distributed assembly with f64 Jacobi-CG, ``BSGShardedOperator`` with
    kernel 1 over each process's two parts (one launch per product,
    against its plain version and bit for bit each part's block alone)
    and the slab CG across the processes, each held to the same solve in
    one process; the phase's own checks fail it otherwise."""
    import chip_smoke

    cfg = dict(hex_box=12, tet_box=16, hex_dof=11 * 13 * 13,
               tet_dof=15 * 17 * 17, device="cuda")
    run = chip_smoke.phase_j(cuda_device, cfg=cfg, out=tmp_path)
    for r in run["workers"]:
        assert (r["backend"], r["staged"], r["device"]) == (
            "gloo", True, "cuda:0")
        assert r["J2"]["per_product"] == 1
        assert r["J2"]["launches"] == r["J2"]["iterations"] + 1
        assert r["J3"]["iterations"] == run["workers"][0]["J3"]["iterations"]
    assert run["checkpoint_rows"] == [0, 1, 2, 3]


def test_the_cli_over_two_processes_on_the_card(cuda_device, tmp_path):
    """``chip_smoke.py`` phase M at a small size: the CLI's ``--partitions
    4`` routes under torchrun, two processes on the card, on a refined 6^3
    tet box (the halo AMG route, kernel 1 in each process) and a 8 x 6 x
    92 box (the f64 refinement over four pad-stencil slabs, kernel 3 in
    f32 and f64 in each process), each bit for bit the same command line
    in one process; the phase's own checks fail it otherwise."""
    import chip_smoke

    run = chip_smoke.phase_m(cuda_device, cfg=dict(
        cells=6, box=(8, 6, 92), box_exo="box8x6x92.exo",
        m2_entries=("ddps_pad_stencil_f32", "ddps_pad_stencil_f64")),
        out=tmp_path)  # no DIA level in this box's hierarchy
    for tag in ("M1", "M2"):
        for r in run[tag]["workers"]:
            assert (r["backend"], r["device"]) == ("gloo", "cuda:0")
            assert r["iterations"] == run[tag]["one_process"]["iterations"]
    assert run["nccl"]["run"] == (torch.cuda.device_count() >= 2)
    launches = chip_smoke.phase_m_launches(run, "sell_spmv")
    assert launches["M1 rank 0"] > 0 and launches["M1 rank 1"] > 0


# ---------------------------------------------------------------------------
# One answer for any number of processes: a process holding k of P parts
# computes each part's arithmetic as one process holding all P does
# ---------------------------------------------------------------------------


class _Processes:
    """``world`` processes of one program, emulated by threads in this
    process on one device: the collectives (all-gather, all-to-all, the
    slab ring, the max of a host value) hand each thread the other
    threads' tensors, as gloo and NCCL hand back the bits they were
    given.  Rank ``r`` runs over ``DeviceMesh(P, device, r, world)``."""

    def __init__(self, monkeypatch, world: int):
        import threading

        from domain_decomposed_pde_solver_tpu_torch.parallel import (
            sharded,
            slab,
            slabpad,
        )

        self.world = world
        self.barrier = threading.Barrier(world, timeout=600)
        self.slots = [None] * world
        self.me = threading.local()
        monkeypatch.setattr(sharded, "gather_parts", self.gather_parts)
        monkeypatch.setattr(sharded, "exchange_rows", self.exchange_rows)
        monkeypatch.setattr(sharded, "max_scalar", self.max_scalar)
        monkeypatch.setattr(slab, "ring_strips", self.ring_strips)
        monkeypatch.setattr(slabpad, "ring_strips", self.ring_strips)

    def _share(self, value) -> list:
        self.slots[self.me.rank] = value
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got

    def gather_parts(self, local):
        return torch.cat(self._share(local))

    def exchange_rows(self, send):
        got = self._share(send)
        return torch.stack([got[s][self.me.rank] for s in range(self.world)])

    def ring_strips(self, first, last):
        got = self._share((first, last))
        r = self.me.rank
        prev = got[r - 1][1] if r > 0 else torch.zeros_like(last)
        nxt = got[r + 1][0] if r + 1 < self.world else torch.zeros_like(first)
        return prev, nxt

    def max_scalar(self, value):
        return max(int(v) for v in self._share(value))

    def run(self, fn) -> list:
        """``fn(rank)`` in every rank's thread; the results in rank
        order.  A failing rank fails the call (the others stop at their
        next collective)."""
        import threading

        out, errors = [None] * self.world, []

        def body(r):
            self.me.rank = r
            try:
                out[r] = fn(r)
            except BaseException as exc:  # re-raised below, in the caller
                errors.append(exc)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        assert not any(t.is_alive() for t in threads), "a rank hung"
        if errors:
            raise errors[0]
        return out


def _proc_mesh(nparts, device, rank, world):
    from domain_decomposed_pde_solver_tpu_torch.parallel.sharded import (
        DeviceMesh,
    )

    return DeviceMesh(nparts, device, rank, world)


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("nparts,n", [(4, 252_480), (8, 16_029)])
def test_part_sums_do_not_depend_on_the_parts_held(cuda_device, monkeypatch,
                                                   name, nparts, n):
    """Each part's tile sums from a ``(k, n)`` slice are the rows of the
    ``(P, n)`` tensor's, bit for bit (J1's and J3's part width first); the
    dot over 2 and 4 processes is the one-process dot's bits."""
    from domain_decomposed_pde_solver_tpu_torch.parallel import sharded

    g = torch.Generator(device=cuda_device).manual_seed(n)
    dt = getattr(torch, name)
    a = torch.randn(nparts, n, generator=g, device=cuda_device, dtype=dt)
    b = torch.randn(nparts, n, generator=g, device=cuda_device, dtype=dt)
    full = sharded.part_tiles(a * b)
    one = sharded.psum_dot(a, b)
    for world in (2, 4):
        k = nparts // world
        for r in range(world):
            sl = slice(r * k, (r + 1) * k)
            assert torch.equal(sharded.part_tiles(a[sl] * b[sl]), full[sl])
        procs = _Processes(monkeypatch, world)
        got = procs.run(lambda r: sharded.psum_dot(
            a[r * k:(r + 1) * k], b[r * k:(r + 1) * k],
            _proc_mesh(nparts, cuda_device, r, world)))
        for d in got:
            assert torch.equal(d, one)


def _hex_plan(device, n=24, nparts=4):
    """J1's route at a small size: a HEX8 box's system over the RCB
    partition of its free nodes, the halo plan and f64 blocks."""
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        build_halo_plan,
        partition_rcb,
    )

    mesh, sy, _dims = _box_system((n, n, n), "HEX8")
    owner = partition_rcb(mesh.coords[sy.free_to_node], nparts)
    return sy, build_halo_plan(sy.A, owner.astype(np.int32), nparts)


def test_products_over_processes_equal_one_process(cuda_device, monkeypatch):
    """The products and the brick cycle over two processes (k = 2 of P =
    4 parts each) give the rows of the one-process result, bit for bit:
    ``ShardedOperator.matvec`` and its diagonal (f64), ``BSGShardedOperator``
    (kernel 1 over the parts, f32), the slab DIA product, the brick cycle with
    its slab-mean correction (f64) and the brick sums of the slab
    hierarchies."""
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        BSGShardedOperator,
        ShardedOperator,
        build_slab_brick_precond,
        build_slab_plan,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel.slab import (
        SlabDIAOperator,
        brick_sum,
    )

    P_, world, k = 4, 2, 2
    procs = _Processes(monkeypatch, world)
    rng = np.random.default_rng(5)
    sy, plan = _hex_plan(cuda_device)
    for cls, dt in ((ShardedOperator, np.float64),
                    (BSGShardedOperator, np.float32)):
        one = cls.from_plan(plan, _proc_mesh(P_, cuda_device, 0, 1), dtype=dt)
        x = one.put_vector(rng.normal(size=sy.n_free))
        y1, d1 = one.matvec(x), one.diagonal()

        def local(r, cls=cls, dt=dt, x=x):
            op = cls.from_plan(plan, _proc_mesh(P_, cuda_device, r, world),
                               dtype=dt)
            return op.matvec(x[r * k:(r + 1) * k]), op.diagonal()

        for r, (y, d) in enumerate(procs.run(local)):
            assert torch.equal(y, y1[r * k:(r + 1) * k]), cls.__name__
            assert torch.equal(d, d1[r * k:(r + 1) * k]), cls.__name__
    mesh, sy, dims = _box_system((16, 16, 24), "TETRA4")
    splan = build_slab_plan(sy.A, P_, dtype=np.float64,
                            row_align=dims[0] * dims[1])
    bp = build_slab_brick_precond(splan, dims, brick=4, dtype=np.float64,
                                  global_coarse=True, A=sy.A)
    xs = torch.as_tensor(rng.normal(size=(P_, splan.slab)), device=cuda_device)
    data = torch.as_tensor(splan.data, device=cuda_device)
    y1 = SlabDIAOperator(data, splan.offsets, splan.halo, splan.slab).matvec(xs)
    z1 = bp.block(cuda_device)(xs)

    def slab_local(r):
        m = _proc_mesh(P_, cuda_device, r, world)
        sl = slice(r * k, (r + 1) * k)
        op = SlabDIAOperator(data[sl], splan.offsets, splan.halo, splan.slab,
                             mesh=m)
        return op.matvec(xs[sl]), bp.block(cuda_device, m)(xs[sl])

    for r, (y, z) in enumerate(procs.run(slab_local)):
        assert torch.equal(y, y1[r * k:(r + 1) * k])
        assert torch.equal(z, z1[r * k:(r + 1) * k])
    # The brick sums with few bricks per part (the slab-pad AMG's at a
    # small size: 2 x 2 x 1 bricks of 6) and many (16 x 16 x 6 of 4).
    for dims, brick, pad in (((7, 7, 6), 6, (9, 8)), ((64, 64, 24), 4, None)):
        size = dims[2] * (pad[0] * pad[1] if pad else dims[0] * dims[1])
        w = torch.as_tensor(rng.normal(size=(P_, size)), device=cuda_device)
        whole = brick_sum(w, dims, brick, pad)
        for r in range(world):
            sl = slice(r * k, (r + 1) * k)
            assert torch.equal(brick_sum(w[sl], dims, brick, pad), whole[sl])


def _route(name, device):
    """A solve of ``chip_smoke.py`` phase J's kind at a small size, as
    ``fn(mesh) -> (host answer, iterations)``."""
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        pad_stencil_from_stencil,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        BSGShardedOperator,
        ShardedOperator,
        build_slab_amg,
        build_slab_pad_amg,
        build_slab_plan,
        sharded_cg_solve,
        slab_amg_cg_solve,
        slab_cg_solve,
        slab_pad_amg_cg_solve,
    )

    if name in ("J1", "J2"):
        sy, plan = _hex_plan(device)
        cls, dt, tol = ((ShardedOperator, np.float64, 1e-8) if name == "J1"
                        else (BSGShardedOperator, np.float32, 1e-6))

        def solve(m):
            op = cls.from_plan(plan, m, dtype=dt)
            b = op.put_vector(sy.b)
            d = op.diagonal()
            inv = torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 0.0)
            res = sharded_cg_solve(op, b, torch.zeros_like(b),
                                   precond_diag=inv, tol=tol, maxiter=5000)
            return op.get_vector(res.x), res.iterations
        return solve
    if name == "J3":
        _mesh, sy, _dims = _box_system((24, 24, 24), "TETRA4")
        plan = build_slab_plan(sy.A, nparts=4)
        b = (sy.b / np.abs(sy.b).max()).astype(np.float32)

        def solve(m):
            x, res = slab_cg_solve(plan, b, np.zeros_like(b), tol=1e-6,
                                   maxiter=5000, mesh=m)
            return x, res.iterations
        return solve
    _mesh, sy, dims = _box_system((8, 6, 20), "TETRA4")
    if name == "slab_amg":
        def solve(m):
            samg = build_slab_amg(sy.A, dims, 4, brick=4, dtype=np.float32,
                                  device=device, mesh=m)
            x, res = slab_amg_cg_solve(samg, sy.b.astype(np.float32),
                                       np.zeros(sy.n_free, np.float32),
                                       tol=1e-6)
            return x, res.iterations
        return solve
    st = choose_operator(sy.A, dtype=torch.float32, grid_dims=dims,
                         device=device)
    pad_op = pad_stencil_from_stencil(st, bz=4)

    def solve(m):
        samg = build_slab_pad_amg(sy.A, dims, 4, pad_op=pad_op, mesh=m)
        x, res = slab_pad_amg_cg_solve(samg, sy.b, np.zeros(sy.n_free),
                                       tol=1e-6)
        return x, res.iterations
    return solve


def test_halo_amg_same_bits_over_runs_and_processes(cuda_device,
                                                   monkeypatch):
    """CG with the global halo AMG over ``BSGShardedOperator`` in f32 on
    the card: two runs, and one process against two (threads, k = 2 of P
    = 4 parts each), give the same iterations and the same answer bit for
    bit (the restriction's segment sums and the coarse tail's are kernel-1
    launches in a fixed order, not atomics)."""
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        BSGShardedOperator,
        build_halo_amg,
        halo_amg_cg_solve,
    )

    sy, plan = _hex_plan(cuda_device, n=16)
    hamg = build_halo_amg(sy.A, plan, dtype=torch.float32,
                          device=cuda_device)
    b = sy.b.astype(np.float32)
    x0 = np.zeros_like(b)

    def solve(m):
        op = BSGShardedOperator.from_plan(plan, m, dtype=np.float32)
        x, res = halo_amg_cg_solve(op, hamg, b, x0, tol=1e-6, maxiter=200)
        assert res.converged
        return x, res.iterations

    x1, it1 = solve(_proc_mesh(4, cuda_device, 0, 1))
    x2, it2 = solve(_proc_mesh(4, cuda_device, 0, 1))
    assert it1 == it2
    np.testing.assert_array_equal(x1, x2)
    procs = _Processes(monkeypatch, 2)
    for x, it in procs.run(lambda r: solve(_proc_mesh(4, cuda_device, r, 2))):
        assert it == it1
        np.testing.assert_array_equal(x, x1)


@pytest.mark.parametrize("route", ["J1", "J2", "J3", "slab_amg",
                                   "slab_pad_amg"])
def test_solves_over_processes_equal_one_process(cuda_device, monkeypatch,
                                                 route):
    """The solves of phase J (f64 Jacobi-CG over ELL blocks, f32
    Jacobi-CG on kernel 1 over the parts, the f32 slab CG) and the slab
    global and slab-pad AMG solves over two processes on the card take one
    process's iterations and give its answer, bit for bit."""
    solve = _route(route, cuda_device)
    x1, it1 = solve(_proc_mesh(4, cuda_device, 0, 1))
    procs = _Processes(monkeypatch, 2)
    for x, it in procs.run(lambda r: solve(_proc_mesh(4, cuda_device, r, 2))):
        assert it == it1
        np.testing.assert_array_equal(x, x1)


# ---------------------------------------------------------------------------
# HYB and Split-ELL on the card; kernel 4 with many diagonals; the build
# cache
# ---------------------------------------------------------------------------


def _hyb_split(d, dtype, device):
    """The HYB (after RCM) and Split-ELL (identity numbering) operators of
    a refined d^3 box on ``device``."""
    from domain_decomposed_pde_solver_tpu_torch.ops import (
        hyb_from_csr,
        rcm_permute,
        splitell_from_csr,
    )

    sy = assemble_heat_system(refine_uniform(box_mesh(d, d, d,
                                                      elem_type="TETRA4"), 1))
    Ap, _perm = rcm_permute(sy.A)
    return (hyb_from_csr(Ap, dtype=dtype, device=device),
            splitell_from_csr(sy.A, dtype=dtype, device=device))


def _far_dia(nd, n, reach, name, device, seed=0):
    """``nd`` random diagonals of an ``n``-row operator, offsets drawn from
    [-reach, reach]: with reach ~ n / 2 no block is interior."""
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import DIAMatrix

    rng = np.random.default_rng(seed)
    offs = np.sort(rng.choice(np.arange(-reach, reach + 1), nd,
                              replace=False))
    data = rng.normal(size=(nd, n)).astype(name)
    rows = np.arange(n)
    for d, o in enumerate(offs):  # zero where the column does not exist
        data[d, (rows + o < 0) | (rows + o >= n)] = 0.0
    return DIAMatrix(data=torch.from_numpy(data).to(device),
                     offsets=tuple(int(o) for o in offs), n_rows=n)


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("case", ["hyb213", "wide300", "wide256"])
def test_dia_kernel_many_diagonals_and_far_offsets(cuda_device, case, name):
    """More than 128 diagonals: the HYB DIA part of a refined 5^3 box (213
    diagonals to about +- the RCM bandwidth, most rows outside the
    interior range), and 256 / 300 random ones reaching +- n/2 (no
    interior block; 300 runs as two launches, the second adding to the
    first's y).  Equal to the plain version; every block bit-identical."""
    if case == "hyb213":
        A = _hyb_split(5, getattr(torch, name), cuda_device)[0].dia
        assert A.ndiags == 213
    else:
        A = _far_dia(int(case[4:]), 6000, 3000, name, cuda_device)
    lo, hi = -min(A.offsets), A.n_pad - max(A.offsets)
    assert lo > 0 and hi < A.n_pad  # rows outside the interior range
    x = torch.as_tensor(np.random.default_rng(36).normal(size=A.n_pad),
                        dtype=getattr(torch, name), device=cuda_device)
    launches = -(-A.ndiags // _kernels.DIA_MAX_DIAGS)
    before = _kernels.DIA_SPMV.launches
    y0 = A.matvec(x)
    torch.cuda.synchronize()
    assert _kernels.DIA_SPMV.launches == before + launches
    assert _relerr(y0, dia_matvec_plain(A, x)) <= TOL[name]
    for block in _kernels.DIA_BLOCKS:
        y = _kernels.dia_spmv_launch(A.data, A.offsets_array, x,
                                     shape=_kernels.DiaLaunch(0, block))
        torch.cuda.synchronize()
        assert torch.equal(y, y0), block


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_hyb_and_splitell_on_the_card_match_their_plain_versions(
        cuda_device, name):
    """HYB's DIA part on kernel 4's run-time loop plus its ELL part, and
    Split-ELL's fixed-order tail (the same bits on two runs), each against
    its plain version on the card and its product on the CPU."""
    from domain_decomposed_pde_solver_tpu_torch.ops.splitell import (
        splitell_matvec_plain,
    )

    dtype = getattr(torch, name)
    H, S = _hyb_split(8, dtype, cuda_device)
    Hc, Sc = _hyb_split(8, dtype, "cpu")
    x = torch.as_tensor(np.random.default_rng(37).normal(size=H.n_pad),
                        dtype=dtype)
    xd = x.to(cuda_device)
    entry = f"ddps_dia_spmv_{'f32_f32' if name == 'float32' else 'f64_f64'}"
    before = _kernels.DIA_SPMV.by_entry[entry]
    yh = H.matvec(xd)
    torch.cuda.synchronize()
    assert _kernels.DIA_SPMV.by_entry[entry] == before + 1
    assert _kernels.dia_launch_shape(H.n_pad, H.dia.ndiags).instance == 0
    assert _relerr(yh, dia_matvec_plain(H.dia, xd) + H.ell.matvec(xd)
                   ) <= TOL[name]
    assert _relerr(yh, Hc.matvec(x)) <= TOL[name]
    ys = S.matvec(xd)
    assert torch.equal(S.matvec(xd), ys)
    assert _relerr(ys, splitell_matvec_plain(S, xd)) <= TOL[name]
    assert _relerr(ys, Sc.matvec(x)) <= TOL[name]
    assert torch.equal(S.diagonal_padded().cpu(), Sc.diagonal_padded())


def test_build_through_enable_persistent_cache(cuda_device, tmp_path,
                                               monkeypatch):
    """``enable_persistent_cache(dir)`` sends the next build there: a fresh
    kernel 4 builds into ``dir``, loads and launches."""
    from domain_decomposed_pde_solver_tpu_torch.utils import compilecache

    monkeypatch.setattr(compilecache, "_chosen", compilecache._chosen)
    cache = tmp_path / "cache"
    assert compilecache.enable_persistent_cache(str(cache)) == str(cache)
    k = _kernels.Kernel(_kernels.DIA_SPMV.name, _kernels.DIA_SPMV.src,
                        _kernels.DIA_SPMV.entries)
    k.library()
    assert len(list(cache.glob("libdia_spmv-*.so"))) == 1
    A = _far_dia(19, 5000, 80, "float32", cuda_device)
    x = torch.ones(A.n_pad, device=cuda_device)
    y = torch.empty_like(x)
    k.launch("ddps_dia_spmv_f32_f32", A.data.data_ptr(),
             A.offsets_array.ctypes.data, A.ndiags, x.data_ptr(),
             y.data_ptr(), A.n_pad, 128, 0, 0,
             torch.cuda.current_stream(cuda_device).cuda_stream)
    torch.cuda.synchronize()
    assert k.launches == 1
    assert _relerr(y, dia_matvec_plain(A, x)) <= TOL["float32"]
