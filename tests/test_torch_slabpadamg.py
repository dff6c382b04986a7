"""The port's global AMG over pad-stencil slabs and its f64 refinement
against the JAX package: ``build_slab_pad_amg`` (the level-0 arrays, the
slab rule with the bz = 4 rebuild), ``slab_pad_amg_cg_solve`` and
``slab_pad_amg_refine_solve``, and the slab hierarchy's count against the
single-device one.

JAX runs each part on one of the 8 virtual CPU devices that
``tests/conftest.py`` forces, its Pallas kernel in interpret mode; the port
drives every part on the CPU, kernel 3's plain version on each window.
Both hierarchies are built on pad-stencil operators from one host stencil
decomposition at bz = 4, where brick 6 gives 6-layer slabs: free grids
7 x 7 x 11 at P = 2 (slabs of 6 and 5 real layers) and 7 x 7 x 21 at P = 4
(6, 6, 6, 3).

Tolerances: set-up arrays equal bit for bit; f32 CG+AMG within one
iteration of JAX's and of the single-device solve (dots summed in another
order), answers to 1e-4; the refinement takes JAX's sweeps, its inner
iterations within one per sweep, each reaches the tolerance, and the two
f64 answers agree to 1e-8 (the last sweep's f32 inner solve).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import domain_decomposed_pde_solver_tpu.parallel as J
from domain_decomposed_pde_solver_tpu.io import box_mesh
from domain_decomposed_pde_solver_tpu.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu.ops.dia import pack_dia_host
from domain_decomposed_pde_solver_tpu.ops.pallas.stencil_kernel import (
    pad_stencil_from_parts as j_pad_stencil,
)
from domain_decomposed_pde_solver_tpu.ops.stencil import (
    stencil_parts_from_packed,
)
from domain_decomposed_pde_solver_tpu.solvers.precond.amg import (
    infer_free_grid,
)
import domain_decomposed_pde_solver_tpu_torch.parallel as T
from domain_decomposed_pde_solver_tpu_torch.solvers.cg import cg_solve
from domain_decomposed_pde_solver_tpu_torch.solvers.precond.amg import (
    smoothed_aggregation_setup,
)
from domain_decomposed_pde_solver_tpu_torch.utils.convert import (
    pad_stencil_from_parts,
)
from domain_decomposed_pde_solver_tpu_torch.utils.timers import RECORDER
from torch_parity import port_csr, relerr

torch.set_num_threads(1)

# parts -> box cells: free grids 7 x 7 x 11 and 7 x 7 x 21.
BOXES = {2: (8, 6, 10), 4: (8, 6, 20)}


@functools.lru_cache(maxsize=None)
def hierarchies(nparts, bz=4):
    """(JAX system, grid, JAX SlabPadAMG, the port's) on pad operators of
    ``bz`` from one host decomposition."""
    mesh = box_mesh(*BOXES[nparts], elem_type="TETRA4")
    sy = assemble_heat_system(mesh)
    dims = infer_free_grid(mesh, sy.free_to_node)
    offs, data = pack_dia_host(sy.A, dtype=jnp.float32)
    parts = stencil_parts_from_packed(offs, data, sy.A.n_rows, dims)
    sj = J.build_slab_pad_amg(sy.A, dims, nparts,
                              pad_op=j_pad_stencil(parts, bz=bz))
    st = T.build_slab_pad_amg(
        port_csr(sy), dims, nparts,
        pad_op=pad_stencil_from_parts(parts, bz=bz, device="cpu"))
    return sy, dims, sj, st


@functools.lru_cache(maxsize=None)
def solves(nparts):
    sy, _dims, sj, st = hierarchies(nparts)
    x0 = np.zeros(sy.n_free)
    return (J.slab_pad_amg_cg_solve(sj, sy.b, x0, tol=1e-6),
            T.slab_pad_amg_cg_solve(st, sy.b, x0, tol=1e-6))


@pytest.mark.parametrize("case", ["P2", "P4", "P2-bz6-rebuild"])
def test_slab_pad_amg_equals_jax(case):
    nparts = int(case[1])
    bz = 6 if "bz6" in case else 4
    sy, dims, sj, st = hierarchies(nparts, bz)
    # bz = 6 with brick 6 has no slab size: both rebuild with bz = 4.
    assert st.plan.bz == sj.plan.bz == 4
    assert st.pad_op.bz == sj.pad_op.bz == 4
    assert st.plan.L == sj.plan.L == 6
    np.testing.assert_array_equal(st.plan.zlims, sj.plan.zlims)
    for f in ("tval", "scale", "inv_diag"):
        got, want = getattr(st, f).cpu().numpy(), np.asarray(getattr(sj, f))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for f in ("lmax", "n_c", "n_pad_c", "slab_c", "brick", "smooth_steps"):
        assert getattr(st, f) == getattr(sj, f), f
    # tval is 0 on every pad slot and dead layer.
    live = st.plan.scatter_vector(np.ones(sy.n_free, np.float32)) != 0
    np.testing.assert_array_equal(st.tval.cpu().numpy()[~live], 0.0)
    (xj, rj), (xt, rt) = solves(nparts)
    assert rt.converged and bool(rj.converged)
    assert abs(rt.iterations - int(rj.iterations)) <= 1
    assert relerr(xt, xj) <= 1e-4


@pytest.mark.parametrize("nparts", [2, 4])
def test_slab_pad_amg_iterations_match_single_device(nparts):
    """P-independence: within one iteration of the single-device CG with
    the same hierarchy on the same pad operator (the port's)."""
    sy, dims, _sj, st = hierarchies(nparts)
    _pair, (_xt, rt) = solves(nparts)
    A = st.pad_op
    M = smoothed_aggregation_setup(port_csr(sy), dtype=torch.float32,
                                   grid_dims=dims, fine_operator=A)
    b = A.put_vector(sy.b)
    r1 = cg_solve(A, b, torch.zeros_like(b), precond=M, tol=1e-6,
                  maxiter=300)
    assert abs(rt.iterations - r1.iterations) <= 1


@pytest.mark.parametrize("start", ["zero-P2", "warm-P4"])
def test_slab_pad_amg_refine_equals_jax(start):
    nparts = int(start[-1])
    sy, _dims, sj, st = hierarchies(nparts)
    x0 = (np.random.default_rng(1).uniform(-1, 1, sy.n_free)
          if start.startswith("warm") else None)
    mj = J.slab_pad_amg_refine_solve(sj, b=sy.b, x0=x0, tol=1e-8)
    mt = T.slab_pad_amg_refine_solve(st, b=sy.b, x0=x0, tol=1e-8)
    assert mt.converged and mj.converged
    assert mt.refinements == mj.refinements
    assert abs(mt.inner_iterations - mj.inner_iterations) <= mt.refinements
    assert mt.relres <= 1e-8 and mt.x.dtype == np.float64
    assert relerr(mt.x, mj.x) <= 1e-8
    r = sy.b - sy.A.matvec(mt.x)
    assert np.linalg.norm(r) <= 1.5e-8 * np.linalg.norm(sy.b)
    assert set(mt.timings) == {"stage_ms", "sweeps_ms", "fetch_ms"}
    # The timings are the durations of the refinement's own spans.
    spans = RECORDER.spans()
    root = [s for s in spans if s.name == "refine"][-1]
    phases = {s.name[len("refine."):] + "_ms": s.ms for s in spans
              if s.parent == root.id}
    assert mt.timings == phases


def test_refine_argument_errors_follow_jax():
    _sy, _dims, _sj, st = hierarchies(2)
    with pytest.raises(ValueError, match="b is required"):
        T.slab_pad_amg_refine_solve(st)
    bare = T.SlabPadAMG(**{**st.__dict__, "pad_op": None})
    with pytest.raises(ValueError, match="pad_op missing"):
        T.slab_pad_amg_refine_solve(bare, b=np.ones(3))
