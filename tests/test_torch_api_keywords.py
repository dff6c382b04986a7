"""The smaller pieces of the JAX package's API against the port: the
injectable ``dot`` of the resumable and snapshot CG, ``transient_heat_solve
(dtype=...)``, ``DIAMatrix.matvec_roll``, ``ELLMatrix.astype``, and the
kernel build cache (``utils.enable_persistent_cache``).

Both packages get the same assembled arrays (a structured TETRA4 box and
a refined one) and numpy-seeded vectors.  Tolerances, from summation
order: f64 products agree to 1e-12 relative, CG takes JAX's iterations
and lands on its answer to 1e-10.  The build cache is checked without
``nvcc``: it only decides where builds go.
"""

import functools
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domain_decomposed_pde_solver_tpu.io import box_mesh as j_box_mesh
from domain_decomposed_pde_solver_tpu.models import assemble_heat_system
from domain_decomposed_pde_solver_tpu.models import transient as j_transient
from domain_decomposed_pde_solver_tpu.ops import dia as j_dia
from domain_decomposed_pde_solver_tpu.ops import ell as j_ell
from domain_decomposed_pde_solver_tpu.solvers import cg as j_cg
from domain_decomposed_pde_solver_tpu.solvers import (
    jacobi_preconditioner as j_jacobi,
)
from domain_decomposed_pde_solver_tpu_torch import utils as p_utils
from domain_decomposed_pde_solver_tpu_torch.models import transient_heat_solve
from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
from domain_decomposed_pde_solver_tpu_torch.ops import dia as p_dia
from domain_decomposed_pde_solver_tpu_torch.ops import ell as p_ell
from domain_decomposed_pde_solver_tpu_torch.solvers import cg as p_cg
from domain_decomposed_pde_solver_tpu_torch.solvers import jacobi_preconditioner
from domain_decomposed_pde_solver_tpu_torch.utils import compilecache
from torch_parity import jax_problem, port_csr, rand, relerr

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _box():
    return assemble_heat_system(j_box_mesh(9, 8, 7, elem_type="TETRA4"))


def _dia_pair(dtype_name):
    sy = _box()
    Aj = j_dia.dia_from_csr(sy.A, dtype=getattr(jnp, dtype_name))
    Ap = p_dia.dia_from_csr(port_csr(sy), dtype=getattr(torch, dtype_name),
                            device="cpu")
    return sy, Aj, Ap


# -- the resumable and snapshot CG take dot= ------------------------------


def _counting_dot(calls):
    def dot(a, b):
        calls.append(1)
        return (a * b).sum()
    return dot


@pytest.mark.parametrize("solver", ["resumable", "snapshots"])
def test_cg_with_a_custom_dot_matches_jax(tmp_path, solver):
    sy, Aj, Ap = _dia_pair("float64")
    bj, bp = Aj.put_vector(sy.b), Ap.put_vector(sy.b)
    calls_j, calls_p = [], []
    kw = dict(tol=1e-10, maxiter=500)
    if solver == "resumable":
        rj = j_cg.cg_solve_resumable(
            Aj, bj, jnp.zeros_like(bj), precond=j_jacobi(Aj),
            checkpoint_path=str(tmp_path / "j.npz"), checkpoint_every=7,
            dot=_counting_dot(calls_j), **kw)
        rp = p_cg.cg_solve_resumable(
            Ap, bp, torch.zeros_like(bp), precond=jacobi_preconditioner(Ap),
            checkpoint_path=str(tmp_path / "p.npz"), checkpoint_every=7,
            dot=_counting_dot(calls_p), **kw)
    else:
        rj = j_cg.cg_solve_snapshots(Aj, bj, jnp.zeros_like(bj),
                                     precond=j_jacobi(Aj),
                                     dot=_counting_dot(calls_j), **kw)
        rp = p_cg.cg_solve_snapshots(Ap, bp, torch.zeros_like(bp),
                                     precond=jacobi_preconditioner(Ap),
                                     dot=_counting_dot(calls_p), **kw)
    assert rp.converged and bool(rj.converged)
    assert rp.iterations == int(rj.iterations)
    assert relerr(Ap.get_vector(rp.x), Aj.get_vector(rj.x)) <= 1e-10
    # JAX traces its jitted step once, so its dot runs at least once; the
    # port's runs in every iteration.
    assert calls_j and len(calls_p) > 2 * rp.iterations


def test_resumable_fingerprint_ignores_dot(tmp_path):
    """A run stopped with one dot resumes with another: the fingerprint
    covers b and the operator only, and the resumed answer is the unbroken
    run's."""
    sy, _Aj, A = _dia_pair("float64")
    b = A.put_vector(sy.b)
    M = jacobi_preconditioner(A)
    path = str(tmp_path / "ck.npz")
    full = p_cg.cg_solve_resumable(A, b, torch.zeros_like(b), precond=M,
                                   checkpoint_path=str(tmp_path / "f.npz"),
                                   checkpoint_every=10, tol=1e-10,
                                   maxiter=500)
    p_cg.cg_solve_resumable(A, b, torch.zeros_like(b), precond=M,
                            checkpoint_path=path, checkpoint_every=10,
                            tol=1e-10, maxiter=20)
    rest = p_cg.cg_solve_resumable(A, b, torch.zeros_like(b), precond=M,
                                   checkpoint_path=path, checkpoint_every=10,
                                   tol=1e-10, maxiter=500,
                                   dot=lambda u, v: torch.dot(u, v))
    assert rest.iterations == full.iterations
    assert torch.equal(rest.x, full.x)


# -- transient_heat_solve(dtype=...) ---------------------------------------


def test_transient_accepts_dtype_and_ignores_it():
    sy, Aj, Ap = _dia_pair("float64")
    kw = dict(dt=0.05, n_steps=4, tol=1e-11)
    rp = transient_heat_solve(sy, Ap, **kw)
    rd = transient_heat_solve(sy, Ap, dtype=torch.float32, **kw)
    np.testing.assert_array_equal(rd.u, rp.u)
    assert rd.total_cg_iterations == rp.total_cg_iterations
    rj = j_transient.transient_heat_solve(sy, Aj, dtype=jnp.float32, **kw)
    assert rp.total_cg_iterations == int(rj.total_cg_iterations)
    assert relerr(rp.u, np.asarray(rj.u)) <= 1e-10


# -- DIAMatrix.matvec_roll and ELLMatrix.astype ----------------------------


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_matvec_roll_matches_matvec_and_jax(dtype_name):
    _sy, Aj, Ap = _dia_pair(dtype_name)
    x = rand(Ap.n_pad, seed=11).astype(dtype_name)
    tol = 1e-12 if dtype_name == "float64" else 1e-6
    yr = Ap.matvec_roll(torch.from_numpy(x)).numpy()
    assert yr.dtype == np.dtype(dtype_name)
    assert relerr(yr, Ap.matvec(torch.from_numpy(x)).numpy()) <= tol
    assert relerr(yr, np.asarray(Aj.matvec_roll(jnp.asarray(x)))) <= tol


def test_ell_astype_matches_jax():
    _mesh, sy = jax_problem((7, 6, 5))
    Ej = j_ell.ell_from_csr(sy.A, dtype=jnp.float64).astype(jnp.float32)
    Ep = p_ell.ell_from_csr(port_csr(sy), dtype=torch.float64,
                            device="cpu").astype(torch.float32)
    assert Ep.dtype == torch.float32 and Ep.cols.dtype == torch.int64
    np.testing.assert_array_equal(Ep.cols.numpy(), np.asarray(Ej.cols))
    np.testing.assert_array_equal(Ep.vals.numpy(), np.asarray(Ej.vals))
    assert Ep.astype("float64").dtype == torch.float64


# -- the kernel build cache ------------------------------------------------


@pytest.fixture
def cache_env(monkeypatch):
    """A clean environment and the cache module's choice restored after
    the test."""
    for var in ("DDPS_COMPILE_CACHE", "DDPS_NO_COMPILE_CACHE",
                "XDG_CACHE_HOME"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(compilecache, "_chosen", compilecache._UNSET)
    monkeypatch.setattr(compilecache, "_temp", None)
    return monkeypatch


def test_cache_is_exported():
    assert p_utils.enable_persistent_cache is compilecache.enable_persistent_cache
    assert "enable_persistent_cache" in p_utils.__all__


def test_checkout_default_is_build_kernels(cache_env):
    repo = pathlib.Path(compilecache.__file__).resolve().parents[2]
    assert compilecache.default_cache_dir() == repo / "build" / "kernels"
    assert _kernels.kernel_build_dir() == repo / "build" / "kernels"


def test_resolution_order(cache_env, tmp_path):
    env_dir, arg_dir = tmp_path / "env", tmp_path / "arg"
    cache_env.setenv("DDPS_COMPILE_CACHE", str(env_dir))
    # Never called: the environment decides at each build.
    assert _kernels.kernel_build_dir() == env_dir
    assert compilecache.enable_persistent_cache(str(arg_dir)) == str(arg_dir)
    assert arg_dir.is_dir() and _kernels.kernel_build_dir() == arg_dir
    assert compilecache.enable_persistent_cache() == str(env_dir)
    assert env_dir.is_dir() and _kernels.kernel_build_dir() == env_dir
    cache_env.delenv("DDPS_COMPILE_CACHE")
    assert compilecache.enable_persistent_cache() == str(
        compilecache.default_cache_dir())


def test_installed_default_is_per_user(cache_env, tmp_path):
    site = tmp_path / "lib" / "python3.12" / "site-packages"
    cache_env.setattr(compilecache, "_PKG", site / "domain_decomposed_pde_"
                      "solver_tpu_torch")
    home = tmp_path / "home"
    cache_env.setenv("HOME", str(home))
    got = compilecache.default_cache_dir()
    assert got == home / ".cache" / "ddps_torch_kernels"
    assert site not in got.parents
    assert _kernels.kernel_build_dir() == got
    cache_env.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert compilecache.default_cache_dir() == (
        tmp_path / "xdg" / "ddps_torch_kernels")
    cache_env.setattr(compilecache, "_PKG", tmp_path / "usr" / "lib" /
                      "python3" / "dist-packages" / "pkg")
    assert compilecache.default_cache_dir() == (
        tmp_path / "xdg" / "ddps_torch_kernels")


def test_no_compile_cache_builds_in_a_fresh_temporary_dir(cache_env,
                                                          tmp_path):
    cache_env.setenv("DDPS_NO_COMPILE_CACHE", "1")
    assert compilecache.enable_persistent_cache(str(tmp_path / "x")) is None
    assert not (tmp_path / "x").exists()
    d = _kernels.kernel_build_dir()
    assert d.is_dir() and d != compilecache.default_cache_dir()
    assert d.name.startswith("ddps_kernels_")
    assert _kernels.kernel_build_dir() == d  # one per process


def test_unwritable_directory_falls_back_to_a_temporary_dir(cache_env,
                                                            tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert compilecache.enable_persistent_cache(str(blocker / "sub")) is None
    assert _kernels.kernel_build_dir().name.startswith("ddps_kernels_")
