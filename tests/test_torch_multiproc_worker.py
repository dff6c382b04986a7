"""One process of the port's multi-process tests (imports no JAX), and
:func:`spawn`, which runs a task in several of them.

Run as::

    python test_torch_multiproc_worker.py TASK RANK WORLD URL OUTDIR [ARG ...]

``URL`` is a ``torch.distributed`` rendezvous (``file://...`` in the
tests: no port to race for under xdist).  Every process computes on the
CPU over gloo and writes ``OUTDIR/TASK.rank{RANK}.npz``; the test compares
the files.

Tasks:

- ``distassembly MESH NPARTS``: ``assemble_heat_multihost`` on the Exodus
  file; this rank's blocks, one sharded product of a seeded vector, and
  f64 Jacobi ``sharded_cg_solve`` to 1e-10.
- ``slabcg NX NY NZ NPARTS``: ``multihost_slab_cg_solve`` in f64 to 1e-10
  on ``box_mesh(NX, NY, NZ, "TETRA4")``, then a sharded checkpoint of the
  iterate written and read back, a mesh of parts that the processes do not
  divide, and the other entry points over the process mesh (:func:`routes`).
- ``cli ROUTES``: the drivers under a launcher (:func:`cli`); the process
  joins a group per run itself, from the ``DDPS_*`` variables.
- ``comm``: the recorder's spans and counters of the collectives
  (:func:`comm`): one halo exchange, one dot, one all-to-all and one f64
  refinement over :data:`PAD_BOX`'s slabs, two per process.
- ``slabio``: the slab-pad plan's put and get over :data:`PAD_BOX`'s
  four slabs (:func:`slabio`), this process's share of them.
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from domain_decomposed_pde_solver_tpu_torch.parallel import (
    initialize_multihost,
    make_device_mesh,
    multihost_slab_cg_solve,
    sharded_cg_solve,
)
from domain_decomposed_pde_solver_tpu_torch.parallel.multihost import (
    load_sharded_checkpoint,
    save_sharded_checkpoint,
)

TOL = 1e-10
TIMEOUT = 180  # seconds the processes of one spawn may take
STENCIL_BOX = (9, 8, 12)  # a TETRA4 box whose matrix is a lattice stencil
PAD_BOX = (8, 6, 20)  # TETRA4: 4 slabs of 6 layers over bz = 4, brick 6


def spawn(task: str, outdir, *args, world: int = 2) -> list:
    """Run ``task`` in ``world`` fresh processes over a ``file://``
    rendezvous in ``outdir``; every process is waited on with a timeout
    (then killed), and any failure fails the caller.  Returns each rank's
    results, in rank order."""
    outdir = pathlib.Path(outdir)
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(repo), env.get("PYTHONPATH", "")])
    url = f"file://{outdir / f'{task}.rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, __file__, task, str(r), str(world), url, str(outdir),
         *map(str, args)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {task}:\n{outs[r][-3000:]}"
    return [dict(np.load(outdir / f"{task}.rank{r}.npz"))
            for r in range(world)]


def distassembly(out: dict, mesh_path: str, nparts: str) -> None:
    from domain_decomposed_pde_solver_tpu_torch.parallel.distassembly import (
        assemble_heat_multihost,
    )

    op, b_s, plan, state = assemble_heat_multihost(
        mesh_path, nparts=int(nparts), device="cpu")
    x = np.random.default_rng(7).standard_normal(state.n_free)
    y = op.get_vector(op.matvec(op.put_vector(x)))
    d = op.diagonal()
    inv = torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 0.0)
    res = sharded_cg_solve(op, b_s, torch.zeros_like(b_s), precond_diag=inv,
                           tol=TOL, maxiter=2000)
    out.update(ell_cols=plan.ell_cols, ell_vals=plan.ell_vals,
               send_idx=plan.send_idx, row_valid=plan.row_valid,
               b_local=b_s.numpy(), b=op.get_vector(b_s), y=y,
               x=op.get_vector(res.x), iterations=res.iterations,
               relres=res.relres, n_local=plan.n_local, H=plan.halo_width,
               world=op.mesh.world, local_parts=op.mesh.local_parts,
               kind=type(op).__name__)


def slabcg(out: dict, nx: str, ny: str, nz: str, nparts: str) -> None:
    from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
    from domain_decomposed_pde_solver_tpu_torch.models import (
        assemble_heat_system,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel.slab import (
        build_slab_plan,
    )

    sy = assemble_heat_system(box_mesh(int(nx), int(ny), int(nz), "TETRA4"))
    plan = build_slab_plan(sy.A, nparts=int(nparts), dtype=np.float64)
    mesh = make_device_mesh(plan.nparts, ["cpu"])
    x, res = multihost_slab_cg_solve(plan, sy.b, np.zeros_like(sy.b),
                                     tol=TOL, maxiter=2000, mesh=mesh)
    prefix = os.path.join(os.path.dirname(out["path"]), "ck")
    save_sharded_checkpoint(prefix, {"x": res.x, "b": sy.b})
    back = load_sharded_checkpoint(prefix)
    try:
        make_device_mesh(3, ["cpu"])
        indivisible = ""
    except ValueError as exc:
        indivisible = str(exc)
    out.update(x=x, iterations=res.iterations, relres=res.relres,
               local=res.x.numpy(), rows=sorted(back["x"]),
               back=np.concatenate([back["x"][r] for r in sorted(back["x"])]),
               has_b="b" in back, mesh_lo=mesh.parts_lo,
               mesh_k=mesh.local_parts, indivisible=indivisible)
    routes(out, sy, plan, mesh)
    slab_routes(out, mesh)


def _raises(fn) -> str:
    """The message of the ``NotImplementedError`` or ``ValueError`` that
    ``fn()`` raises; ``""`` if it returns."""
    try:
        fn()
    except (NotImplementedError, ValueError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return ""


def routes(out: dict, sy, plan, mesh) -> None:
    """The one-controller entry points over the process ``mesh``, each
    beside the same call over a mesh of one process, which stays
    one-process inside the process group: ``slab_cg_solve``,
    ``slab_stencil_cg_solve`` (f32 to 1e-6, on the lattice-stencil form
    of :data:`STENCIL_BOX`'s system), and over a ``ShardedOperator`` (f64
    to 1e-10) the halo AMG CG, block-Schwarz AMG CG, two-level Schwarz
    CG and block-ILUT GMRES; a collective and a per-part preconditioner
    refuse a tensor of all the parts, and a hierarchy refuses a mesh it
    was not built over."""
    from types import SimpleNamespace

    from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
    from domain_decomposed_pde_solver_tpu_torch.models import (
        assemble_heat_system,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import (
        choose_operator,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        ShardedOperator,
        build_block_amg,
        build_block_ilu,
        build_halo_amg,
        build_halo_plan,
        halo_amg_cg_solve,
        sharded_gmres_solve,
        slab_cg_solve,
        slab_pad_cg_solve,
        slab_stencil_cg_solve,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel.sharded import (
        DeviceMesh,
        psum,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel.schwarz import (
        build_coarse_correction,
    )
    from domain_decomposed_pde_solver_tpu_torch.solvers.precond.amg import (
        infer_free_grid,
    )

    P_ = plan.nparts
    one = DeviceMesh(P_, torch.device("cpu"))
    x0 = np.zeros_like(sy.b)
    for name, m in (("proc", mesh), ("one", one)):
        x, res = slab_cg_solve(plan, sy.b, x0, tol=TOL, maxiter=2000, mesh=m)
        out[f"slab_{name}_x"], out[f"slab_{name}_it"] = x, res.iterations
    box = box_mesh(*STENCIL_BOX, "TETRA4")
    st = assemble_heat_system(box)
    S = choose_operator(st.A, dtype=torch.float32, device="cpu",
                        grid_dims=infer_free_grid(box, st.free_to_node))
    b32 = (st.b / np.abs(st.b).max()).astype(np.float32)
    for name, m in (("proc", mesh), ("one", one)):
        x, res = slab_stencil_cg_solve(S, P_, b32, np.zeros_like(b32),
                                       tol=1e-6, maxiter=800, mesh=m)
        out[f"stencil_{name}_x"] = x
        out[f"stencil_{name}_it"] = res.iterations
        out[f"stencil_{name}_shape"] = tuple(res.x.shape)
    hplan = build_halo_plan(sy.A, (np.arange(sy.A.n_rows) * P_)
                            // sy.A.n_rows, P_)
    hamg = build_halo_amg(sy.A, hplan, dtype=torch.float64, device="cpu")
    for name, m in (("proc", mesh), ("one", one)):
        op = ShardedOperator.from_plan(hplan, m)
        x, res = halo_amg_cg_solve(op, hamg, sy.b, x0, tol=TOL, maxiter=200)
        out[f"halo_amg_{name}_x"] = x
        out[f"halo_amg_{name}_it"] = res.iterations
    coarse = build_coarse_correction(sy.A, hplan, device="cpu")
    for name, m in (("proc", mesh), ("one", one)):
        op = ShardedOperator.from_plan(hplan, m)
        b_s = op.put_vector(sy.b)
        x0_s = torch.zeros_like(b_s)
        bamg = build_block_amg(sy.A, hplan, dtype=torch.float64,
                               coarse_size=16, device="cpu", mesh=m)
        ilut = build_block_ilu(sy.A, hplan, dtype=torch.float64,
                               device="cpu", mesh=m)
        valid = torch.from_numpy(m.local(hplan.row_valid))
        for solve, res in (
                ("block_amg", sharded_cg_solve(
                    op, b_s, x0_s, block_amg=bamg, tol=TOL, maxiter=200)),
                ("two_level", sharded_cg_solve(
                    op, b_s, x0_s, block_amg=bamg, coarse_inv=coarse,
                    row_valid=valid, tol=TOL, maxiter=200)),
                ("block_ilut", sharded_gmres_solve(
                    op, b_s, x0_s, block_precond=ilut, tol=TOL,
                    maxiter=400))):
            out[f"{solve}_{name}_x"] = op.get_vector(res.x)
            out[f"{solve}_{name}_it"] = res.iterations
        out[f"block_amg_{name}_parts"] = len(bamg.parts)
    whole = build_block_ilu(sy.A, hplan, dtype=torch.float64, device="cpu")
    op = ShardedOperator.from_plan(hplan, mesh)
    b_s = op.put_vector(sy.b)
    built = SimpleNamespace(nparts=P_, device=torch.device("cpu"),
                            mesh=one)
    out.update(
        refuse_whole_block=_raises(lambda: sharded_gmres_solve(
            op, b_s, b_s, block_precond=whole, maxiter=2)),
        refuse_other_mesh=_raises(lambda: slab_pad_cg_solve(
            built, sy.b, x0, mesh=mesh)),
        refuse_all_parts=_raises(lambda: psum(torch.ones(P_), mesh)))


def slab_routes(out: dict, mesh) -> None:
    """The slab engines that upload at build time, each built and solved
    over the process ``mesh`` and over a mesh of one process: slab CG with
    the brick preconditioner (with and without the slab-mean correction,
    f64 to 1e-10) and the slab global AMG (f64, DIA fine level, to 1e-10;
    f32, lattice-stencil fine level, to 1e-6) on :data:`STENCIL_BOX`'s
    system; on :data:`PAD_BOX`'s at ``bz = 4``, slab-pad Jacobi CG and
    slab-pad AMG CG (f32 to 1e-6, kernel 3's plain version per window)
    and the f64 refinement over it to 1e-10."""
    from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
    from domain_decomposed_pde_solver_tpu_torch.models import (
        assemble_heat_system,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import pack_dia_host
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil import (
        stencil_parts_from_packed,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        pad_stencil_from_parts,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        build_slab_amg,
        build_slab_brick_precond,
        build_slab_pad_amg,
        build_slab_plan,
        slab_amg_cg_solve,
        slab_cg_solve,
        slab_pad_amg_cg_solve,
        slab_pad_amg_refine_solve,
        slab_pad_cg_solve,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel.sharded import (
        DeviceMesh,
    )
    from domain_decomposed_pde_solver_tpu_torch.solvers.precond.amg import (
        infer_free_grid,
    )

    def system(box):
        m = box_mesh(*box, "TETRA4")
        sy = assemble_heat_system(m)
        return sy, infer_free_grid(m, sy.free_to_node)

    P_ = mesh.nparts
    meshes = (("proc", mesh), ("one", DeviceMesh(P_, torch.device("cpu"))))
    sy, dims = system(STENCIL_BOX)
    A, x0 = sy.A, np.zeros_like(sy.b)
    plan = build_slab_plan(A, P_, dtype=np.float64,
                           row_align=dims[0] * dims[1])
    for route, kw in (("brick", {}), ("brick_global", dict(
            global_coarse=True, A=A))):
        bp = build_slab_brick_precond(plan, dims, brick=4, dtype=np.float64,
                                      **kw)
        for name, m in meshes:
            x, res = slab_cg_solve(plan, sy.b, x0, tol=TOL, maxiter=2000,
                                   mesh=m, brick_precond=bp)
            out[f"{route}_{name}_x"], out[f"{route}_{name}_it"] = (
                x, res.iterations)
    for route, dt, tol in (("slab_amg_f64", np.float64, TOL),
                           ("slab_amg_f32", np.float32, 1e-6)):
        for name, m in meshes:
            samg = build_slab_amg(A, dims, P_, brick=4, dtype=dt,
                                  device="cpu", mesh=m)
            x, res = slab_amg_cg_solve(samg, sy.b.astype(dt),
                                       x0.astype(dt), tol=tol)
            out[f"{route}_{name}_x"], out[f"{route}_{name}_it"] = (
                x, res.iterations)
    sy, dims = system(PAD_BOX)
    offs, data = pack_dia_host(sy.A, dtype=torch.float32)
    pad_op = pad_stencil_from_parts(
        stencil_parts_from_packed(offs, data, sy.A.n_rows, dims), bz=4,
        device="cpu")
    x0 = np.zeros_like(sy.b)
    for name, m in meshes:
        spamg = build_slab_pad_amg(sy.A, dims, P_, pad_op=pad_op, mesh=m)
        out[f"pad_{name}_L"] = spamg.plan.L
        for route, (x, res) in (
                ("slab_pad", slab_pad_cg_solve(spamg.plan, sy.b, x0,
                                               tol=1e-6, maxiter=2000)),
                ("slab_pad_amg", slab_pad_amg_cg_solve(spamg, sy.b, x0,
                                                       tol=1e-6))):
            out[f"{route}_{name}_x"], out[f"{route}_{name}_it"] = (
                x, res.iterations)
        mr = slab_pad_amg_refine_solve(spamg, b=sy.b, tol=TOL)
        out[f"slab_pad_refine_{name}_x"] = mr.x
        out[f"slab_pad_refine_{name}_it"] = mr.inner_iterations


def comm(out: dict) -> None:
    """What the recorder holds of the collectives of one halo exchange of
    the slab-pad operator, one dot, one ``exchange_rows`` and one f64
    slab-pad refinement, each under a probe span of its own: per probe,
    the names of the spans of its request and the sums of their
    counters."""
    from collections import Counter

    from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
    from domain_decomposed_pde_solver_tpu_torch.models import (
        assemble_heat_system,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import pack_dia_host
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil import (
        stencil_parts_from_packed,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        pad_stencil_from_parts,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        build_slab_pad_amg,
        slab_pad_amg_refine_solve,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel.collectives import (
        exchange_rows,
    )
    from domain_decomposed_pde_solver_tpu_torch.solvers.precond.amg import (
        infer_free_grid,
    )
    from domain_decomposed_pde_solver_tpu_torch.utils.timers import RECORDER

    m = box_mesh(*PAD_BOX, "TETRA4")
    sy = assemble_heat_system(m)
    dims = infer_free_grid(m, sy.free_to_node)
    offs, data = pack_dia_host(sy.A, dtype=torch.float32)
    pad_op = pad_stencil_from_parts(
        stencil_parts_from_packed(offs, data, sy.A.n_rows, dims), bz=4,
        device="cpu")
    mesh = make_device_mesh(4, ["cpu"])
    samg = build_slab_pad_amg(sy.A, dims, 4, pad_op=pad_op, mesh=mesh)
    plan = samg.plan
    x = plan.put_vector(np.arange(sy.A.n_rows, dtype=np.float32))
    rank = torch.distributed.get_rank()
    probes = {
        "halo": lambda: samg.A.extended(x),
        "dot": lambda: mesh.dot(x, x),
        "exchange": lambda: exchange_rows(
            torch.full((2, 3), float(rank), dtype=torch.float64)),
        "refine": lambda: slab_pad_amg_refine_solve(samg, b=sy.b, tol=TOL),
    }
    for name, fn in probes.items():
        with RECORDER.span("probe") as probe:
            fn()
        spans = [s for s in RECORDER.spans()
                 if s.request == probe.request and s is not probe]
        totals = Counter()
        for s in spans:
            totals.update(s.counts or {})
        out[f"{name}_spans"] = np.array(sorted(s.name for s in spans))
        out[f"{name}_collectives"] = totals["collectives"]
        out[f"{name}_comm_bytes"] = totals["comm_bytes"]
        out[f"{name}_parents"] = np.array(sorted(
            f"{s.name}<{p.name}" for s in spans for p in spans
            if s.parent == p.id))
    out.update(layer=plan.myp * plan.mxp, local_parts=mesh.local_parts,
               slab=plan.slab)


def slabio(out: dict) -> None:
    """A slab-pad plan over :data:`PAD_BOX`'s four slabs of 6 layers (the
    last one 3) on the process mesh: each put of a seeded vector in f32
    and f64 beside this process's rows of the host scatter; the f64 put of
    the vector with NaN in every row outside this process's layers; and
    the gathers of the f64 put, the first written into before the second
    is made."""
    from domain_decomposed_pde_solver_tpu_torch.io import box_mesh
    from domain_decomposed_pde_solver_tpu_torch.models import (
        assemble_heat_system,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops.dia import pack_dia_host
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil import (
        stencil_parts_from_packed,
    )
    from domain_decomposed_pde_solver_tpu_torch.ops.stencil_kernel import (
        pad_stencil_from_parts,
    )
    from domain_decomposed_pde_solver_tpu_torch.parallel import (
        build_slab_pad_stencil,
    )
    from domain_decomposed_pde_solver_tpu_torch.solvers.precond.amg import (
        infer_free_grid,
    )

    m = box_mesh(*PAD_BOX, "TETRA4")
    sy = assemble_heat_system(m)
    dims = infer_free_grid(m, sy.free_to_node)
    offs, data = pack_dia_host(sy.A, dtype=torch.float32)
    pad_op = pad_stencil_from_parts(
        stencil_parts_from_packed(offs, data, sy.A.n_rows, dims), bz=4,
        device="cpu")
    mesh = make_device_mesh(4, ["cpu"])
    plan = build_slab_pad_stencil(pad_op, 4, z_align=6, mesh=mesh)
    x = np.random.default_rng(11).standard_normal(sy.A.n_rows)
    for dt in (np.float32, np.float64):
        name = np.dtype(dt).name
        out[f"put_{name}"] = plan.put_vector(x, dtype=dt).numpy()
        out[f"scatter_{name}"] = mesh.local(plan.scatter_vector(x, dt))
    layer, mz = dims[0] * dims[1], dims[2]
    lo, hi = (min(p * plan.L, mz) * layer
              for p in (mesh.parts_lo, mesh.parts_lo + mesh.local_parts))
    nan = np.full_like(x, np.nan)
    nan[lo:hi] = x[lo:hi]
    out["nan_put"] = plan.put_vector(nan, dtype=np.float64).numpy()
    xd = plan.put_vector(x, dtype=np.float64)
    first = plan.gather_vector(xd)
    out.update(first_owns=first.flags.owndata,
               first_shares=np.shares_memory(first, xd.numpy()),
               first=first.copy())
    first[:] = -1.0
    out.update(again=plan.gather_vector(xd), put_after=xd.numpy(), x=x,
               rows=(lo, hi), L=plan.L, local_parts=mesh.local_parts)


def _patched(route: str, rank: int):
    """What a route changes in process 1, to see the others fail with it:
    ``mismatch`` swaps two parts of its partition, ``raise`` raises in
    its halo plan's build."""
    from domain_decomposed_pde_solver_tpu_torch import parallel

    if rank != 1 or route not in ("mismatch", "raise"):
        return contextlib.nullcontext()
    if route == "raise":
        return mock.patch.object(parallel, "build_halo_plan", side_effect=(
            RuntimeError("a failure in process 1")))
    real = parallel.partition_graph

    def swapped(*a, **k):
        parts = real(*a, **k)
        return np.where(parts == 0, 1, np.where(parts == 1, 0, parts))

    return mock.patch.object(parallel, "partition_graph", swapped)


def cli(out: dict, routes: str) -> None:
    """Each run of the JSON file ``routes`` (``{name: [driver, arg, ...]}``,
    ``driver`` ``solve`` or ``matrix_test``, ``{rank}`` in an argument this
    process's rank) through the driver's ``main``, as under a launcher: the
    ``DDPS_*`` variables name a rendezvous file per run, and ``main`` joins
    and leaves the group.  Keeps each run's exit code, standard output and
    error, the exception it raised and its seconds."""
    from domain_decomposed_pde_solver_tpu_torch.cli import matrix_test, solve

    rank = int(os.environ["DDPS_PROCESS_ID"])
    outdir = pathlib.Path(out["path"]).resolve().parent
    for name, (driver, *argv) in json.loads(
            pathlib.Path(routes).read_text()).items():
        os.environ["DDPS_COORDINATOR"] = \
            f"file://{outdir / f'cli.{name}.rendezvous'}"
        main = {"solve": solve.main, "matrix_test": matrix_test.main}[driver]
        stdout, stderr = io.StringIO(), io.StringIO()
        rc, error, rep, t0 = -1, "", {}, time.perf_counter()
        with _patched(name, rank), contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            try:
                rc = main([a.format(rank=rank) for a in argv], report=rep)
            except (RuntimeError, ValueError, SystemExit) as exc:
                error = f"{type(exc).__name__}: {exc}"
        out.update({f"{name}_rc": rc, f"{name}_stdout": stdout.getvalue(),
                    f"{name}_precond": type(rep.get("precond")).__name__,
                    f"{name}_stderr": stderr.getvalue(),
                    f"{name}_error": error,
                    f"{name}_s": time.perf_counter() - t0})


def main(task, rank, world, url, outdir, *args) -> int:
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    joins = task != "cli"  # the drivers join a group themselves
    if joins:
        got = initialize_multihost(url, world, rank, device="cpu",
                                   timeout_s=120)
        assert got == rank, (got, rank)
    else:
        os.environ.update(DDPS_NUM_PROCESSES=str(world),
                          DDPS_PROCESS_ID=str(rank))
    out = {"path": os.path.join(outdir, f"{task}.rank{rank}.npz")}
    {"distassembly": distassembly, "slabcg": slabcg, "cli": cli,
     "comm": comm, "slabio": slabio}[task](out, *args)
    path = out.pop("path")
    np.savez(path, **out)
    if joins:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
