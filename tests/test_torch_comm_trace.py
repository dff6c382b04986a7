"""The recorder's spans and counters of the collectives across processes
(``parallel/collectives.py``): ``comm.halo``, ``comm.gather`` and
``comm.exchange``, each counting ``collectives`` and the ``comm_bytes``
its process sends; ``comm.dot`` around a dot across processes, the parent
of its gather; and the slab-pad plan's put and get as ``request.put`` and
``request.get``.

Two processes over gloo (``tests/test_torch_multiproc_worker.py``'s task
``comm``) run one halo exchange, one dot, one all-to-all and one f64
refinement over four slabs; one process running the same refinement
records no ``comm.*`` span and no collective.  The ``cuda`` case counts
the bytes of a plan's put and get on the card (the real rows only, all
through page-locked buffers) and skips without one; the file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_comm_trace.py
"""

from collections import Counter

import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
from domain_decomposed_pde_solver_tpu_torch.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu_torch.ops.dia import pack_dia_host
from domain_decomposed_pde_solver_tpu_torch.ops.stencil import (
    stencil_parts_from_packed,
)
from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
    pad_stencil_from_parts,
)
from domain_decomposed_pde_solver_tpu_torch.parallel import (
    build_slab_pad_amg,
    build_slab_pad_stencil,
    slab_pad_amg_refine_solve,
)
from domain_decomposed_pde_solver_tpu_torch.solvers.precond.amg import (
    infer_free_grid,
)
from domain_decomposed_pde_solver_tpu_torch.utils.timers import RECORDER
from test_torch_multiproc_worker import PAD_BOX, spawn


@pytest.fixture(scope="module")
def comm_run(tmp_path_factory):
    return spawn("comm", tmp_path_factory.mktemp("comm"))


@pytest.mark.parametrize("rank", [0, 1])
def test_one_halo_exchange_sends_one_strip_per_neighbour(comm_run, rank):
    """Of two processes each has one neighbour: one strip of one padded
    z-layer (``myp * mxp`` float32 values) goes out, in one collective."""
    r = comm_run[rank]
    assert list(r["halo_spans"]) == ["comm.halo"]
    assert r["halo_collectives"] == 1
    assert r["halo_comm_bytes"] == r["layer"] * 4


@pytest.mark.parametrize("rank", [0, 1])
def test_a_dot_across_processes_is_a_span_over_its_gather(comm_run, rank):
    """The dot gathers each part's tiles of 32 float32 partial sums; its
    process sends its own tiles to the other one."""
    r = comm_run[rank]
    assert list(r["dot_spans"]) == ["comm.dot", "comm.gather"]
    assert list(r["dot_parents"]) == ["comm.gather<comm.dot"]
    assert r["dot_collectives"] == 1
    assert r["dot_comm_bytes"] == r["local_parts"] * -(-r["slab"] // 32) * 4


@pytest.mark.parametrize("rank", [0, 1])
def test_an_all_to_all_sends_every_row_but_its_own(comm_run, rank):
    r = comm_run[rank]
    assert list(r["exchange_spans"]) == ["comm.exchange"]
    assert r["exchange_collectives"] == 1
    assert r["exchange_comm_bytes"] == 3 * 8  # one float64 row of three


def test_a_refinement_across_processes_counts_its_collectives(comm_run):
    for r in comm_run:
        names = Counter(r["refine_spans"])
        # A gather under each dot, and more: each V-cycle's coarse
        # residual and the answer's get.
        assert 0 < names["comm.dot"] < names["comm.gather"]
        assert {"comm.halo", "request.put", "request.get"} <= set(names)
        assert "comm.exchange" not in names  # the slab route has no halo plan
        assert r["refine_collectives"] == sum(
            names[n] for n in ("comm.halo", "comm.gather", "comm.exchange"))
        assert r["refine_comm_bytes"] > 0
    # Both processes make the same collectives in step.
    assert comm_run[0]["refine_collectives"] == \
        comm_run[1]["refine_collectives"]


def _pad_box(device="cpu"):
    m = box_mesh(*PAD_BOX, "TETRA4")
    sy = assemble_heat_system(m)
    dims = infer_free_grid(m, sy.free_to_node)
    offs, data = pack_dia_host(sy.A, dtype=torch.float32)
    pad_op = pad_stencil_from_parts(
        stencil_parts_from_packed(offs, data, sy.A.n_rows, dims), bz=4,
        device=device)
    return sy, dims, pad_op


def _request_spans(fn):
    with RECORDER.span("probe") as probe:
        out = fn()
    return out, [s for s in RECORDER.spans()
                 if s.request == probe.request and s is not probe]


def test_one_process_records_no_collective():
    sy, dims, pad_op = _pad_box()
    samg = build_slab_pad_amg(sy.A, dims, 4, pad_op=pad_op)
    mr, spans = _request_spans(
        lambda: slab_pad_amg_refine_solve(samg, b=sy.b, tol=1e-10))
    assert mr.converged
    names = {s.name for s in spans}
    assert not {n for n in names if n.startswith("comm.")}
    assert {"request.put", "request.get", "refine.sweeps"} <= names
    counted = Counter()
    for s in spans:
        counted.update(s.counts or {})
    assert counted["collectives"] == 0 and counted["comm_bytes"] == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_slab_plan_put_and_get_bytes_on_the_card(card):
    """A plan's put uploads the vector's real rows and its get fetches
    them, no pad slot and no dead layer, both through page-locked
    buffers."""
    _sy, _dims, pad_op = _pad_box(card)
    plan = build_slab_pad_stencil(pad_op, 4, z_align=6)
    n = pad_op.n_rows
    x = np.arange(n, dtype=np.float64)
    xd, put = _request_spans(lambda: plan.put_vector(x, dtype=np.float64))
    total = Counter()
    for s in put:
        total.update(s.counts or {})
    assert [s.name for s in put] == ["request.put"]
    assert total == {"h2d_bytes": n * 8, "pinned_bytes": n * 8}
    back, get = _request_spans(lambda: plan.gather_vector(xd))
    total = Counter()
    for s in get:
        total.update(s.counts or {})
    assert [s.name for s in get] == ["request.get"]
    assert total == {"d2h_bytes": n * 8, "pinned_bytes": n * 8,
                     "host_syncs": 1}
    np.testing.assert_array_equal(back, x)
