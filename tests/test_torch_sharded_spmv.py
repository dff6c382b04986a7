"""Kernel 1 over all of a process's parts: the stacked sliced-ELL operator
of ``BSGShardedOperator`` and the fixed-order segment sums of the AMG
restrictions, on the CPU (the plain versions).

The port packs the real rows of every local part as one operator whose
columns are positions in the vector the parts gather from
(``BSGShardedOperator.local``); JAX runs each part's square block over its
extended-local space on its own device.  Here the same refined tet box,
the same partition (JAX's ``partition_graph``) and the same numpy-seeded
vectors go through both.

Tolerances: the stacked product and each part's block alone add the same
products in the same order, so they agree bit for bit; the port and JAX
multiply the same bfloat16-stored values by the same float32 inputs and
add a row's products in another order (column order against JAX's
micro-op order), so they agree to float32 summation order, 1e-6
relative.  A segment sum adds exact products (value 1) in ascending order,
as ``index_add_`` does on the CPU: bit for bit; split into pieces, it is
``index_add_`` into the pieces and then into the segments, bit for bit.
"""

import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import domain_decomposed_pde_solver_tpu.parallel as J
from domain_decomposed_pde_solver_tpu.ops import coo_to_csr as j_coo_to_csr
from domain_decomposed_pde_solver_tpu.parallel.sharded import AXIS as J_AXIS
import domain_decomposed_pde_solver_tpu_torch.parallel as T
from domain_decomposed_pde_solver_tpu_torch.ops.bsg import (
    SEGMENT_WIDTH,
    SLICE,
    segment_sum_operator,
    spmv_plain,
)
from domain_decomposed_pde_solver_tpu_torch.parallel import sharded
from domain_decomposed_pde_solver_tpu_torch.parallel.sharded import DeviceMesh
from torch_parity import jax_problem, port_csr, relerr

torch.set_num_threads(1)

PARTS = [2, 4, 8]
DIMS = (5, 5, 5)  # refined: 826 free DOF
TOL_F32 = 1e-6


def _partition(sy, nparts):
    A = sy.A
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    off = rows != A.indices
    adj = j_coo_to_csr(rows[off], A.indices[off], np.ones(int(off.sum())),
                       A.shape, sum_dups=False)
    return J.partition_graph(adj, nparts)


def _plans(nparts, dims=DIMS):
    mesh, sy = jax_problem(dims)
    parts = _partition(sy, nparts)
    pj = J.build_halo_plan(sy.A, parts, nparts, dtype=np.float32)
    pt = T.build_halo_plan(port_csr(sy), parts, nparts, dtype=np.float32)
    return sy, pj, pt


def _jax_bsg_matvec(opj, x_host):
    """JAX's ``BSGShardedOperator`` product under ``shard_map`` over the
    virtual CPU devices, as its solvers run it (each part's block through
    ``BSGMatrix.matvec``, the plain XLA evaluation off the TPU)."""
    make_block = type(opj).make_block

    def body(leaves, x_blk):
        blk = jax.tree_util.tree_map(lambda a: a[0], leaves)
        return make_block(opj, blk).matvec(x_blk[0])[None]

    y = jax.shard_map(body, mesh=opj.mesh, in_specs=(JP(J_AXIS),) * 2,
                      out_specs=JP(J_AXIS), check_vma=False)(
        opj.block_leaves(), opj.put_vector(x_host))
    return opj.get_vector(y)


@pytest.mark.parametrize("nparts", PARTS)
def test_stacked_matvec_matches_jax(nparts):
    """The port's one product over all parts against JAX's per-device
    products, f32 vectors on bfloat16 storage (JAX's rule for these
    values), within f32 summation order; and against the host CSR."""
    sy, pj, pt = _plans(nparts)
    opj = J.BSGShardedOperator.from_plan(pj, J.make_device_mesh(nparts))
    opt = T.BSGShardedOperator.from_plan(pt, T.make_device_mesh(nparts,
                                                                ["cpu"]))
    assert opt.local.storage == "bfloat16"
    assert opt.local.n_pad == nparts * pt.n_local  # real rows, no padding
    x = np.random.default_rng(nparts).normal(size=sy.A.n_rows)
    y = opt.matvec(opt.put_vector(x))
    assert y.shape == (nparts, pt.n_local) and y.dtype == torch.float32
    got = opt.get_vector(y)
    assert relerr(got, _jax_bsg_matvec(opj, x.astype(np.float32))) <= TOL_F32
    assert relerr(got, sy.A.matvec(x.astype(np.float32))) <= TOL_F32


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("nparts", PARTS)
def test_stacked_plain_equals_each_part_alone(nparts, name):
    """The stacked layout's plain version gives each part's rows of its
    block alone (``parts``, over ``extended``) bit for bit, in f32 and
    f64 vectors; the padding rows of the smaller parts are exactly 0."""
    sy, _pj, pt = _plans(nparts)
    op = T.BSGShardedOperator.from_plan(pt, T.make_device_mesh(nparts,
                                                               ["cpu"]))
    dt = getattr(torch, name)
    x = torch.as_tensor(np.random.default_rng(3).normal(
        size=(nparts, pt.n_local)), dtype=dt)
    y = op.matvec(x)
    assert y.dtype == dt
    xe = op.extended(x)
    n = pt.n_local
    for p, blk in enumerate(op.parts):
        assert blk.storage == op.local.storage
        yp = spmv_plain(blk, xe[p])
        assert torch.equal(y[p], yp[:n]), p
        assert not yp[n:].any()
    assert not y[~torch.as_tensor(pt.row_valid)].any()


def test_slices_straddle_parts_when_n_local_is_not_a_multiple_of_32():
    """A partition whose ``n_local`` is not a multiple of 32 puts the rows
    of two parts in one 32-row slice, whose padding slots then add an
    exact 0 to the narrower parts' rows: the product stays each part's
    bit for bit."""
    for nparts in PARTS:
        sy, _pj, pt = _plans(nparts)
        if pt.n_local % SLICE:
            break
    assert pt.n_local % SLICE, "no partition with a ragged part width"
    op = T.BSGShardedOperator.from_plan(pt, T.make_device_mesh(nparts,
                                                               ["cpu"]))
    n = pt.n_local
    straddle = [p for p in range(1, nparts) if (p * n) % SLICE]
    assert straddle
    # Padding slots point past the source vector.
    assert bool((op.local.cols[op.local.vals == 0] == op.local.x_len).all())
    x = torch.as_tensor(np.random.default_rng(9).normal(size=(nparts, n)),
                        dtype=torch.float32)
    y, xe = op.matvec(x), op.extended(x)
    for p in straddle:
        for q in (p - 1, p):
            assert torch.equal(y[q], spmv_plain(op.parts[q], xe[q])[:n])


def test_stacked_columns_read_the_source_vector():
    """One process: the operator reads ``x`` itself (``source``), its
    columns positions in the flattened ``(P, n_local)`` vector and its
    padding slots past it; the host CSR product in f64 agrees to f64
    summation order."""
    sy, _pj, pt = _plans(4)
    pt64 = T.build_halo_plan(port_csr(sy), _partition(sy, 4), 4)
    op = T.BSGShardedOperator.from_plan(pt64, T.make_device_mesh(4, ["cpu"]))
    A = op.local
    assert A.x_len == 4 * pt64.n_local
    real = A.vals != 0
    assert bool((A.cols[real] < A.x_len).all())
    assert bool((A.cols[~real] == A.x_len).all())
    x = np.random.default_rng(2).normal(size=sy.A.n_rows)
    y = op.get_vector(op.matvec(op.put_vector(x)))
    assert relerr(y, sy.A.matvec(x)) <= 1e-13


class _Threads:
    """``world`` processes emulated by threads on the CPU: the all-gather
    and all-to-all hand each thread the others' tensors."""

    def __init__(self, monkeypatch, world):
        self.world = world
        self.barrier = threading.Barrier(world, timeout=120)
        self.slots = [None] * world
        self.me = threading.local()
        monkeypatch.setattr(sharded, "gather_parts", self.gather_parts)
        monkeypatch.setattr(sharded, "exchange_rows", self.exchange_rows)
        monkeypatch.setattr(sharded, "max_scalar", self.max_scalar)

    def _share(self, value):
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

    def max_scalar(self, value):
        return max(int(v) for v in self._share(value))

    def run(self, fn):
        out, errors = [None] * self.world, []

        def body(r):
            self.me.rank = r
            try:
                out[r] = fn(r)
            except BaseException as exc:  # noqa: BLE001 -- re-raised below
                errors.append(exc)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


@pytest.mark.parametrize("nparts", [4, 8])
def test_stacked_matvec_over_processes_equals_one_process(monkeypatch,
                                                          nparts):
    """Two processes (threads), each holding k = P/2 parts: each packs its
    parts over ``[x | halo]`` (the halo after its own values), and its
    rows are the one-process product's, bit for bit."""
    _sy, _pj, pt = _plans(nparts)
    one = T.BSGShardedOperator.from_plan(
        pt, DeviceMesh(nparts, torch.device("cpu")))
    x = torch.as_tensor(np.random.default_rng(nparts).normal(
        size=(nparts, pt.n_local)), dtype=torch.float32)
    y1 = one.matvec(x)
    k = nparts // 2
    procs = _Threads(monkeypatch, 2)

    def local(r):
        op = T.BSGShardedOperator.from_plan(
            pt, DeviceMesh(nparts, torch.device("cpu"), r, 2))
        assert op.local.n_pad == k * pt.n_local
        assert op.local.x_len == k * pt.n_local + k * nparts * pt.halo_width
        return op.matvec(x[r * k:(r + 1) * k].contiguous())

    for r, y in enumerate(procs.run(local)):
        assert torch.equal(y, y1[r * k:(r + 1) * k])


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_sum_equals_index_add(seed, name):
    """The segment-sum operator's plain version is ``index_add_`` over the
    valid entries, bit for bit; empty segments give 0."""
    rng = np.random.default_rng(seed)
    n, n_seg = 3000 + 17 * seed, 257
    seg = rng.integers(0, n_seg - 7, n)  # the last 7 segments stay empty
    valid = rng.random(n) < 0.9
    dt = getattr(torch, name)
    x = torch.as_tensor(rng.normal(size=n), dtype=dt)
    S = segment_sum_operator(seg, n_seg, valid=valid, device="cpu")
    assert S.total is None  # every segment one thread's: one launch
    assert S.pieces.storage == "int8" and S.pieces.n_pad == n_seg
    assert S.pieces.x_len == n
    want = torch.zeros(n_seg, dtype=dt).index_add_(
        0, torch.as_tensor(seg[valid]), x[torch.as_tensor(valid)])
    got = S.matvec(x)
    assert torch.equal(got, want)
    assert not got[-7:].any()


@pytest.mark.parametrize("width", [1, 7, SEGMENT_WIDTH])
def test_wide_segments_are_summed_in_pieces(width):
    """Segments wider than ``width`` (aggregates of hundreds of rows, as
    brick aggregation makes) are added in pieces of at most ``width``
    consecutive entries, then the pieces in order: ``index_add_`` into
    the pieces and then into the segments, bit for bit, and ``index_add_``
    straight into the segments to f64 summation order; empty segments give
    0 and a segment of at most ``width`` entries is one piece."""
    rng = np.random.default_rng(width)
    n, n_seg = 6000, 12
    seg = np.sort(rng.integers(0, n_seg - 2, n))  # the last 2 stay empty
    seg[:width] = n_seg - 3  # one segment of exactly `width` entries...
    seg[seg == n_seg - 3] = n_seg - 4
    seg[rng.permutation(n)[:width]] = n_seg - 3
    seg = rng.permutation(seg)
    valid = rng.random(n) < 0.95
    valid[seg == n_seg - 3] = True
    x = torch.as_tensor(rng.normal(size=n))
    S = segment_sum_operator(seg, n_seg, valid=valid, width=width,
                             device="cpu")
    assert S.total is not None and S.width == width
    assert S.total.n_pad == n_seg and S.total.x_len == S.pieces.n_pad
    # The same pieces by hand: each segment's valid entries in ascending
    # order, cut every `width`.
    i = np.flatnonzero(valid)
    o = np.argsort(seg[i], kind="stable")
    rows, cols = seg[i][o], i[o]
    lens = np.bincount(rows, minlength=n_seg)
    first = np.concatenate([[0], np.cumsum(-(-lens // width))])
    start = np.concatenate([[0], np.cumsum(lens)[:-1]])
    piece = first[rows] + (np.arange(rows.size) - start[rows]) // width
    assert S.pieces.n_pad == first[-1]
    parts = torch.zeros(int(first[-1]), dtype=x.dtype).index_add_(
        0, torch.as_tensor(piece), x[torch.as_tensor(cols)])
    want = torch.zeros(n_seg, dtype=x.dtype).index_add_(
        0, torch.as_tensor(np.repeat(np.arange(n_seg), np.diff(first))),
        parts)
    got = S.matvec(x)
    assert torch.equal(got, want)
    direct = torch.zeros(n_seg, dtype=x.dtype).index_add_(
        0, torch.as_tensor(seg[valid]), x[torch.as_tensor(valid)])
    assert relerr(got.numpy(), direct.numpy()) <= 1e-13
    assert not got[-2:].any()
    assert first[n_seg - 2] - first[n_seg - 3] == 1  # `width` entries: 1 piece
