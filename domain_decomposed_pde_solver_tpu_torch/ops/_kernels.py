"""Build and bind the port's hand-written CUDA kernels.

The sources live in ``csrc/`` and are compiled at first use with ``nvcc``
into shared libraries with a plain C interface, loaded through ``ctypes``
(no PyTorch headers, so a build takes seconds).  The libraries go to the
repository's ``build/kernels/`` under names derived from a hash of each
source and the shared headers (``csrc/*.cuh``), so an edited source never
loads a stale build.  Nothing is compiled or loaded when this module is
imported: the CPU tests import it on machines without ``nvcc``.
:func:`build_kernels` starts one ``nvcc`` per source, all at once.

Each launch function checks what the kernel cannot check itself (device,
dtype, shape, contiguity), launches on ``torch.cuda.current_stream()``,
raises if ``cudaGetLastError()`` reports a failed launch, and counts its
launches in plain integers: :attr:`Kernel.launches` in all, and
:attr:`Kernel.by_entry` per C entry point (one per instantiation), and
:attr:`Kernel.by_form` per form of a launch (the pad-stencil kernel's
``"window"`` launches on a z-slab).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "CLUSTER_CTA_ROWS",
    "CLUSTER_MAX_CTAS",
    "CLUSTER_MAX_WINDOW",
    "CLUSTER_SMEM_BUDGET",
    "CLUSTER_SMEM_TAIL",
    "DIA_BLOCKS",
    "DIA_INSTANCES",
    "DIA_SPMV",
    "DiaLaunch",
    "FUSED_CG",
    "FUSED_CG_MODES",
    "Kernel",
    "PAD_STENCIL",
    "SELL_CHUNKED_SPMV",
    "SELL_SPMV",
    "WARP_CHUNKS",
    "build_kernels",
    "cluster_smem_bytes",
    "dia_floor_launch",
    "dia_launch_shape",
    "dia_spmv_launch",
    "fused_cg_cluster_launch",
    "fused_cg_launch",
    "kernel_build_dir",
    "pad_stencil_launch",
    "pad_stencil_window_launch",
    "sell_chunked_spmv",
    "sell_spmv",
]

_PKG = pathlib.Path(__file__).resolve().parents[1]
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_F32 = ctypes.c_float


def kernel_build_dir() -> pathlib.Path:
    return _PKG.parent / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class Kernel:
    """One CUDA source compiled to one shared library, loaded on demand.

    ``entries`` maps each C entry point that launches the kernel to its
    ctypes argument types; every one returns an ``int`` (a
    ``cudaError_t``).  ``defines`` are the source's build-time constants
    (``-DNAME=value``)."""

    def __init__(self, name: str, src: pathlib.Path,
                 entries: Dict[str, Sequence],
                 defines: Optional[Dict[str, int]] = None):
        self.name = name
        self.src = src
        self.entries = dict(entries)
        self.flags = [f"-D{k}={v}" for k, v in (defines or {}).items()]
        self.launches = 0
        self.by_entry: Dict[str, int] = {e: 0 for e in self.entries}
        self.by_form: Dict[str, int] = {}
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def reset(self) -> None:
        """Set every launch count to 0."""
        self.launches = 0
        self.by_entry = {e: 0 for e in self.entries}
        self.by_form = {}

    def library(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
            return self._lib

    def _build_and_load(self) -> ctypes.CDLL:
        headers = b"".join(h.read_bytes()
                           for h in sorted(self.src.parent.glob("*.cuh")))
        digest = hashlib.sha256(self.src.read_bytes() + headers + " ".join(
            self.flags).encode()).hexdigest()[:16]
        out_dir = kernel_build_dir()
        so = out_dir / f"lib{self.name}-{digest}.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [
                _nvcc(), _ARCH, "-std=c++17", "-O3", "-shared",
                "-Xcompiler", "-fPIC", "-Xptxas", "-v", *self.flags,
                "-o", str(tmp), str(self.src),
            ]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed to build {self.src.name} "
                    f"(exit {proc.returncode}):\n{self.build_log}"
                )
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.ddps_error_string.restype = ctypes.c_char_p
        lib.ddps_error_string.argtypes = [ctypes.c_int]
        for fn, argtypes in self.entries.items():
            f = getattr(lib, fn)
            f.restype = ctypes.c_int
            f.argtypes = list(argtypes)
        return lib

    def launch(self, entry: str, *args, form: Optional[str] = None) -> None:
        """Call ``entry``, raise on a failed launch, count it (and under
        ``form`` in :attr:`by_form` when one is named)."""
        code = getattr(self.library(), entry)(*args)
        if code != 0:
            msg = self.library().ddps_error_string(code).decode()
            raise RuntimeError(f"{self.name} launch failed: {msg} ({code})")
        self.launches += 1
        self.by_entry[entry] += 1
        if form is not None:
            self.by_form[form] = self.by_form.get(form, 0) + 1


_SELL_ARGS = [_P] * 5 + [_I64, _I64, _P]
# Storage x vectors: int8, bf16 and f32 values (JAX's storages) with f32 or
# f64 vectors, f64 values with f64 vectors.
_SELL_TYPES = ("i8_f32", "i8_f64", "bf16_f32", "bf16_f64", "f32_f32",
               "f32_f64", "f64_f64")
SELL_SPMV = Kernel("sell_spmv", _PKG / "csrc" / "spmv.cu", {
    f"ddps_sell_spmv_{t}": _SELL_ARGS for t in _SELL_TYPES})

# data, offsets (host int64), ndiags, x, y, n, block, instance, stream
_DIA_ARGS = [_P, _P, _INT, _P, _P, _I64, _INT, _INT, _P]
# x, y, n, block, stream
_DIA_COPY_ARGS = [_P, _P, _I64, _INT, _P]
DIA_SPMV = Kernel("dia_spmv", _PKG / "csrc" / "dia_spmv.cu", {
    "ddps_dia_spmv_bf16_f32": _DIA_ARGS,
    "ddps_dia_spmv_f32_f32": _DIA_ARGS,
    "ddps_dia_spmv_bf16_f64": _DIA_ARGS,
    "ddps_dia_spmv_f32_f64": _DIA_ARGS,
    "ddps_dia_spmv_f64_f64": _DIA_ARGS,
    # Measurement entries: the launch floor and one dependent load of a
    # product's grid (``dia_floor_launch``); the port never calls them.
    "ddps_dia_floor_noop": [_I64, _INT, _P],
    "ddps_dia_floor_copy_f32": _DIA_COPY_ARGS,
    "ddps_dia_floor_copy_f64": _DIA_COPY_ARGS,
})

# x, corr, y, taps (host int32 (n_taps, 3)), n_taps, group_start (host
# int32), n_groups, quads (host f32), mx, my, mz, myp, mxp, Z, zc, stream
_PAD_ARGS = [_P, _P, _P, _P, _INT, _P, _INT, _P] + [_INT] * 7 + [_P]
PAD_STENCIL = Kernel("pad_stencil", _PKG / "csrc" / "pad_stencil.cu", {
    "ddps_pad_stencil_f32_bf16": _PAD_ARGS,
    "ddps_pad_stencil_f32_f32": _PAD_ARGS,
    "ddps_pad_stencil_f64_bf16": _PAD_ARGS,
    "ddps_pad_stencil_f64_f32": _PAD_ARGS,
})

# The ragged layout's chunks per warp: a slice of at most this many chunks
# is one warp's work, the chunks of a wider one go one per warp.  The kernel
# takes it at build time; ``bsg._chunk_maps`` lists the wide chunks by it.
WARP_CHUNKS = 4

# slice_ptr, cols, vals, tmap, chunk_ptr, wide, partial, arrivals, x, y,
# n_slices, n_wide, chunk, n_out, n_x, stream
_CHUNKED_ARGS = [_P] * 10 + [_I64, _I64, _INT, _I64, _I64, _P]
SELL_CHUNKED_SPMV = Kernel(
    "sell_chunked_spmv", _PKG / "csrc" / "sell_chunked_spmv.cu", {
        f"ddps_sell_chunked_spmv_{t}": _CHUNKED_ARGS for t in _SELL_TYPES
    }, defines={"DDPS_WARP_CHUNKS": WARP_CHUNKS})

# Grid instance: slice_ptr, cols, vals, b, invd, x, r, p, ap, part,
# max_blocks, stats, n, maxiter, tol2, stream.  Cluster instance: vals,
# lcols, slice_ptr, windows, b, invd, x0, x, stats, ctas, max_slots,
# max_win, maxiter, tol2, active_out, stream.  Each instance has an entry per
# value storage (f32, i8, bf16; the vectors are always f32).  The study
# entries (f32 storage) take a mode first (0: barriers and reductions only,
# 1: and the matvec, 2: the solve); measurements only, the port never calls
# them.
_GRID_ARGS = [_P] * 10 + [_I64, _P, _I64, _INT, _F32, _P]
_CLUSTER_ARGS = [_P] * 9 + [_INT] * 4 + [_F32, _P, _P]

# The cluster instance's layout, defined here once: the kernel takes these
# at build time, and the instance rule (solvers/fused_cg.py) decides from
# them which operators it admits.
CLUSTER_CTA_ROWS = 1024  # rows (and threads) of a CTA of the cluster instance
CLUSTER_MAX_CTAS = 16  # the largest (non-portable) cluster on Hopper
CLUSTER_MAX_WINDOW = 1 << 16  # 16-bit local columns
CLUSTER_SMEM_BUDGET = 232_448  # a block's opt-in shared memory on Hopper
# A CTA's shared memory after its slots and two windows: 6 x 16 pushed
# partials and 32 x 3 warp sums (8 B each), 64 B of mbarriers and 16 window
# starts (4 B); the source holds its own layout to this with a static_assert.
CLUSTER_SMEM_TAIL = (8 * 6 * CLUSTER_MAX_CTAS + 8 * 3 * (CLUSTER_CTA_ROWS // 32)
                     + 64 + 4 * CLUSTER_MAX_CTAS)

FUSED_CG = Kernel("fused_cg", _PKG / "csrc" / "fused_cg.cu", {
    **{f"ddps_fused_cg_{v}": _GRID_ARGS for v in ("f32", "i8", "bf16")},
    **{f"ddps_fused_cg_cluster_{v}": _CLUSTER_ARGS
       for v in ("f32", "i8", "bf16")},
    "ddps_fused_cg_study_f32": [_INT] + _GRID_ARGS,
    "ddps_fused_cg_cluster_study_f32": [_INT] + _CLUSTER_ARGS,
}, defines={"DDPS_CLUSTER_CTA_ROWS": CLUSTER_CTA_ROWS,
            "DDPS_CLUSTER_MAX_CTAS": CLUSTER_MAX_CTAS,
            "DDPS_CLUSTER_MAX_WINDOW": CLUSTER_MAX_WINDOW,
            "DDPS_CLUSTER_SMEM_BUDGET": CLUSTER_SMEM_BUDGET,
            "DDPS_CLUSTER_SMEM_TAIL": CLUSTER_SMEM_TAIL})
FUSED_CG_MODES = {"barriers": 0, "matvec": 1, "solve": 2}

KERNELS = (SELL_SPMV, PAD_STENCIL, DIA_SPMV, SELL_CHUNKED_SPMV, FUSED_CG)

_NAME = {torch.int8: "i8", torch.bfloat16: "bf16", torch.float32: "f32",
         torch.float64: "f64"}


def build_kernels() -> List[Kernel]:
    """Build (or load) every kernel of the port, one ``nvcc`` per source
    started together; returns the kernels."""
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        list(pool.map(lambda k: k.library(), KERNELS))
    return list(KERNELS)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _require_cuda(x: torch.Tensor, what: str) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"{what} launches on CUDA tensors, got {x.device}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D tensor")
    return x.device


def sell_spmv(slice_ptr: torch.Tensor, cols: torch.Tensor,
              vals: torch.Tensor, x: torch.Tensor, n_out: int) -> torch.Tensor:
    """Launch the sliced-ELL SpMV on CUDA tensors; returns y (n_out,).

    ``x`` may be shorter than the operator's input space (zero-extended by
    the kernel); columns are int32, ``slice_ptr`` int64 of length
    ``ceil(n_out / 32) + 1``."""
    dev = _require_cuda(x, "sell_spmv")
    for name, t in (("slice_ptr", slice_ptr), ("cols", cols), ("vals", vals)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if slice_ptr.dtype != torch.int64 or cols.dtype != torch.int32:
        raise TypeError("slice_ptr must be int64 and cols int32")
    entry = f"ddps_sell_spmv_{_NAME.get(vals.dtype)}_{_NAME.get(x.dtype)}"
    if entry not in SELL_SPMV.entries:
        raise TypeError(
            f"no kernel for {vals.dtype} storage with {x.dtype} vectors"
        )
    n_slices = -(-n_out // 32)
    if slice_ptr.numel() != n_slices + 1 or cols.numel() != vals.numel():
        raise ValueError(
            f"inconsistent sliced-ELL arrays: {slice_ptr.numel()} slice "
            f"pointers for {n_out} rows, {cols.numel()} cols vs "
            f"{vals.numel()} vals"
        )
    y = torch.empty(n_out, dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        SELL_SPMV.launch(
            entry, slice_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            x.data_ptr(), y.data_ptr(), n_out, x.numel(), _stream(dev),
        )
    return y


def sell_chunked_spmv(slice_ptr: torch.Tensor, cols: torch.Tensor,
                      vals: torch.Tensor, tmap: torch.Tensor,
                      chunk_ptr: torch.Tensor, wide: torch.Tensor, chunk: int,
                      x: torch.Tensor, n_out: int) -> torch.Tensor:
    """Launch the chunked sliced-ELL SpMV on CUDA tensors; returns y
    (n_out,).

    The slots are the dense layout's (``slice_ptr`` int64 of
    ``ceil(n_out / 32) + 1``, ``cols`` int32); ``tmap`` (int32, chunk ->
    slice), ``chunk_ptr`` (int32, first chunk of every slice) and ``wide``
    (int32, the chunks of slices of more than ``WARP_CHUNKS`` chunks) cut
    them into chunks of ``chunk`` columns.  ``x`` may be shorter than the
    operator's input space (zero-extended by the kernel)."""
    dev = _require_cuda(x, "sell_chunked_spmv")
    named = (("slice_ptr", slice_ptr), ("cols", cols), ("vals", vals),
             ("tmap", tmap), ("chunk_ptr", chunk_ptr), ("wide", wide))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if slice_ptr.dtype != torch.int64 or any(
            t.dtype != torch.int32 for t in (cols, tmap, chunk_ptr, wide)):
        raise TypeError("slice_ptr must be int64; cols, tmap, chunk_ptr and "
                        "wide int32")
    entry = (f"ddps_sell_chunked_spmv_{_NAME.get(vals.dtype)}_"
             f"{_NAME.get(x.dtype)}")
    if entry not in SELL_CHUNKED_SPMV.entries:
        raise TypeError(
            f"no kernel for {vals.dtype} storage with {x.dtype} vectors"
        )
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    n_slices = -(-n_out // 32)
    if (cols.numel() != vals.numel() or slice_ptr.numel() != n_slices + 1
            or chunk_ptr.numel() != n_slices + 1
            or wide.numel() > tmap.numel()):
        raise ValueError(
            f"inconsistent chunked arrays: {cols.numel()} cols, "
            f"{vals.numel()} vals, {slice_ptr.numel()} slice and "
            f"{chunk_ptr.numel()} chunk pointers for {n_out} rows, "
            f"{wide.numel()} wide of {tmap.numel()} chunks"
        )
    n_wide = wide.numel()
    y = torch.empty(n_out, dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        partial = torch.empty(n_wide * 32, dtype=x.dtype, device=dev)
        arrivals = torch.zeros(n_wide, dtype=torch.int32, device=dev)
        SELL_CHUNKED_SPMV.launch(
            entry, slice_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            tmap.data_ptr(), chunk_ptr.data_ptr(), wide.data_ptr(),
            partial.data_ptr(), arrivals.data_ptr(), x.data_ptr(),
            y.data_ptr(), n_slices, n_wide, chunk, n_out, x.numel(),
            _stream(dev),
        )
    return y


# Value storages of the fused CG kernel (its vectors are float32).
_FUSED_VALUES = (torch.int8, torch.bfloat16, torch.float32)


def _fused_checks(b: torch.Tensor, named) -> torch.device:
    """Device, shape and type checks shared by both instances: int8, bf16
    or f32 values, f32 vectors."""
    dev = _require_cuda(b, "fused_cg")
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, b on {dev}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if any(t.dtype != torch.float32 for name, t in (("b", b), *named)
           if name in ("b", "invd", "x0")):
        raise TypeError("the fused CG kernel takes float32 vectors")
    vals = dict(named)["vals"]
    if vals.dtype not in _FUSED_VALUES:
        raise TypeError(f"no fused CG kernel for {vals.dtype} storage (it "
                        "takes int8, bfloat16 or float32)")
    return dev


def _fused_entry(base: str, mode: str, vals: torch.Tensor):
    """The C entry and its leading arguments for ``mode``: the solve's own
    entry for the values' storage, or the study entry of a measurement mode
    (float32 storage only)."""
    if mode not in FUSED_CG_MODES:
        raise ValueError(f"mode must be one of {sorted(FUSED_CG_MODES)}")
    if mode == "solve":
        return f"ddps_fused_cg{base}_{_NAME[vals.dtype]}", ()
    if vals.dtype != torch.float32:
        raise TypeError("the study entries take float32 storage")
    return f"ddps_fused_cg{base}_study_f32", (FUSED_CG_MODES[mode],)


def fused_cg_launch(slice_ptr: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor, b: torch.Tensor, invd: torch.Tensor,
                    x0: torch.Tensor, tol: float, maxiter: int,
                    mode: str = "solve"):
    """Launch the whole Jacobi-PCG solve on CUDA tensors, once: the grid
    instance (a cooperative grid, any size).

    A square sliced-ELL operator of ``n = b.numel()`` rows with int8,
    bfloat16 or float32 values (``slice_ptr`` int64 of ``ceil(n / 32) +
    1``, ``cols`` int32), float32 ``b``, ``invd`` and ``x0`` of ``n``
    entries.  Returns ``(x, stats)``: ``stats`` a float64 device tensor
    ``[iterations, relres, converged, rnorm2]``, for the caller to read
    once.  ``mode`` other than
    ``"solve"`` runs a measurement entry (:data:`FUSED_CG_MODES`)."""
    n = b.numel()
    dev = _fused_checks(b, (("slice_ptr", slice_ptr), ("cols", cols),
                            ("vals", vals), ("invd", invd), ("x0", x0)))
    if slice_ptr.dtype != torch.int64 or cols.dtype != torch.int32:
        raise TypeError("slice_ptr must be int64 and cols int32")
    if (invd.numel() != n or x0.numel() != n
            or slice_ptr.numel() != -(-n // 32) + 1
            or cols.numel() != vals.numel()):
        raise ValueError(f"inconsistent operator or vectors for {n} rows")
    entry, lead = _fused_entry("", mode, vals)
    # The kernel sizes its grid from the occupancy calculator; no SM holds
    # more than 2048 threads, so 2048 / 256 blocks per SM bound it.
    max_blocks = (torch.cuda.get_device_properties(dev).multi_processor_count
                  * (2048 // 256))
    with torch.cuda.device(dev):
        x = x0.clone()
        r, p, ap = (torch.empty_like(b) for _ in range(3))
        part = torch.empty(6 * max_blocks, dtype=torch.float64, device=dev)
        stats = torch.empty(4, dtype=torch.float64, device=dev)
        FUSED_CG.launch(
            entry, *lead, slice_ptr.data_ptr(), cols.data_ptr(),
            vals.data_ptr(), b.data_ptr(), invd.data_ptr(), x.data_ptr(),
            r.data_ptr(), p.data_ptr(), ap.data_ptr(), part.data_ptr(),
            max_blocks, stats.data_ptr(), n, int(maxiter),
            float(np.float32(tol * tol)), _stream(dev),
        )
    return x, stats


def cluster_smem_bytes(max_slots: int, max_win: int,
                       value_bytes: int = 4) -> int:
    """Dynamic shared memory of a CTA of the cluster instance (the source's
    ``cluster_smem_bytes``): slot values (``value_bytes``: 4 for float32,
    2 for bfloat16, 1 for int8) and columns (2 B), two windows (z and p;
    4 B an entry), each region rounded up to 16 B, and
    :data:`CLUSTER_SMEM_TAIL`."""
    def align16(v):
        return -(-v // 16) * 16

    return (align16((value_bytes + 2) * max_slots) + 2 * align16(4 * max_win)
            + CLUSTER_SMEM_TAIL)


def fused_cg_cluster_launch(vals: torch.Tensor, lcols: torch.Tensor,
                            slice_ptr: torch.Tensor, windows: torch.Tensor,
                            max_slots: int, max_win: int, b: torch.Tensor,
                            invd: torch.Tensor, x0: Optional[torch.Tensor],
                            tol: float, maxiter: int, mode: str = "solve"):
    """Launch the whole Jacobi-PCG solve on CUDA tensors, once: the cluster
    instance, ``n / 1024`` CTAs of 1024 rows with the operator in shared
    memory.

    The operator's ``vals`` (int8, bfloat16 or float32) and int64
    ``slice_ptr`` (sliced ELL), its slots' 16-bit window columns ``lcols``
    (int16 bits), ``windows`` int32 ``(lo, width)`` per CTA and the
    largest CTA's slots and window: a
    :class:`..solvers.fused_cg.ClusterPack`.  ``x0`` may be None (0).
    Returns ``(x, stats, active)``: ``stats`` as :func:`fused_cg_launch`'s,
    ``active`` the launch's ``cudaOccupancyMaxActiveClusters``."""
    n = b.numel()
    named = [("vals", vals), ("lcols", lcols), ("slice_ptr", slice_ptr),
             ("windows", windows), ("invd", invd)]
    if x0 is not None:
        named.append(("x0", x0))
    dev = _fused_checks(b, named)
    ctas = n // CLUSTER_CTA_ROWS
    if (n % CLUSTER_CTA_ROWS or not 0 < ctas <= CLUSTER_MAX_CTAS
            or invd.numel() != n or (x0 is not None and x0.numel() != n)
            or slice_ptr.numel() != n // 32 + 1
            or lcols.numel() != vals.numel() or windows.numel() != 2 * ctas):
        raise ValueError(f"inconsistent cluster pack or vectors for {n} rows")
    if (slice_ptr.dtype != torch.int64 or lcols.dtype != torch.int16
            or windows.dtype != torch.int32):
        raise TypeError("lcols must be int16, slice_ptr int64 and windows "
                        "int32")
    if vals.data_ptr() % 16 or lcols.data_ptr() % 16:
        raise ValueError("vals and lcols must be 16-byte aligned (the "
                         "kernel copies them in 16-byte vectors)")
    entry, lead = _fused_entry("_cluster", mode, vals)
    active = ctypes.c_int(0)
    with torch.cuda.device(dev):
        x = torch.empty_like(b)
        stats = torch.empty(4, dtype=torch.float64, device=dev)
        FUSED_CG.launch(
            entry, *lead, vals.data_ptr(), lcols.data_ptr(),
            slice_ptr.data_ptr(), windows.data_ptr(), b.data_ptr(),
            invd.data_ptr(), 0 if x0 is None else x0.data_ptr(),
            x.data_ptr(), stats.data_ptr(), ctas, int(max_slots),
            int(max_win), int(maxiter), float(np.float32(tol * tol)),
            ctypes.addressof(active), _stream(dev),
        )
    return x, stats, active.value


_DIA_MAX_DIAGS = 128  # the kernel's parameter block holds this many offsets
# Diagonal counts with a compiled instance: the TETRA4 (19) and HEX8 (27)
# stencils and the 23 of level 2 of the TETRA4 box's brick hierarchy, the
# counts of every DIA level the structured routes build.
DIA_INSTANCES = (19, 23, 27)
DIA_BLOCKS = (32, 64, 128, 256)  # the launch shapes the kernel takes
_DIA_LARGE = 1 << 17  # rows from which a product takes large blocks


@dataclasses.dataclass(frozen=True)
class DiaLaunch:
    """How kernel 4 runs one product: ``instance`` is the compiled diagonal
    count (0: the run-time loop), ``block`` the threads per block (one row
    per thread)."""

    instance: int
    block: int


def dia_launch_shape(n: int, nd: int) -> DiaLaunch:
    """Kernel 4's instance and launch shape for an ``(nd, n)`` operator:
    the compiled instance of ``nd`` if there is one, else the run-time
    loop; blocks of 128 threads below 2^17 rows (a small level spreads over
    the SMs), of 256 above.  The rule is the sweep's (``chip_smoke.py``
    phase E, PERF.md): no block was more than 2 % faster at any measured
    size, and the storage and vector types did not move the best block."""
    instance = nd if nd in DIA_INSTANCES else 0
    return DiaLaunch(instance, 128 if n < _DIA_LARGE else 256)


def dia_spmv_launch(data: torch.Tensor, offsets, x: torch.Tensor, *,
                    shape: Optional[DiaLaunch] = None) -> torch.Tensor:
    """Launch the DIA SpMV on CUDA tensors; returns y (n_pad,).

    ``data`` is (ndiags, n_pad), contiguous, bf16/f32 storage with f32 or
    f64 vectors or f64 storage with f64 vectors; ``offsets`` are host ints
    (at most 128; a contiguous int64 numpy array is passed as it is).
    ``shape`` overrides :func:`dia_launch_shape` (measurements and tests:
    every shape gives bit-identical results)."""
    dev = _require_cuda(x, "dia_spmv")
    if data.device != dev:
        raise ValueError(f"data is on {data.device}, x on {dev}")
    if data.dim() != 2 or not data.is_contiguous():
        raise ValueError("data must be a contiguous (ndiags, n_pad) tensor")
    nd, n = data.shape
    if x.numel() != n:
        raise ValueError(f"x has {x.numel()} entries, the operator {n} rows")
    if len(offsets) != nd or not 0 < nd <= _DIA_MAX_DIAGS:
        raise ValueError(f"{len(offsets)} offsets for {nd} diagonals "
                         f"(the kernel takes 1 to {_DIA_MAX_DIAGS})")
    entry = f"ddps_dia_spmv_{_NAME.get(data.dtype)}_{_NAME.get(x.dtype)}"
    if entry not in DIA_SPMV.entries:
        raise TypeError(
            f"no kernel for {data.dtype} storage with {x.dtype} vectors"
        )
    if shape is None:
        shape = dia_launch_shape(n, nd)
    if shape.block not in DIA_BLOCKS or shape.instance not in (0, nd):
        raise ValueError(f"no launch {shape} for {nd} diagonals")
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    y = torch.empty(n, dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        DIA_SPMV.launch(
            entry, data.data_ptr(), offs.ctypes.data, nd, x.data_ptr(),
            y.data_ptr(), n, shape.block, shape.instance, _stream(dev),
        )
    return y


def dia_floor_launch(kind: str, x: torch.Tensor, shape: DiaLaunch) -> None:
    """Measurement only (the port never calls it): launch kernel 4's
    ``"noop"`` kernel (does nothing) or its ``"copy"`` kernel (reads ``x``,
    writes a new vector of its length), on the grid and block of a product
    of ``x.numel()`` rows in ``shape``.  Counted like any launch."""
    dev = _require_cuda(x, "dia_floor")
    if shape.block not in DIA_BLOCKS:
        raise ValueError(f"no launch {shape}")
    n = x.numel()
    with torch.cuda.device(dev):
        if kind == "noop":
            DIA_SPMV.launch("ddps_dia_floor_noop", n, shape.block,
                            _stream(dev))
            return
        if kind != "copy" or x.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"no floor kernel {kind!r} for {x.dtype}")
        y = torch.empty_like(x)
        DIA_SPMV.launch(f"ddps_dia_floor_copy_{_NAME[x.dtype]}", x.data_ptr(),
                        y.data_ptr(), n, shape.block, _stream(dev))


_PAD_MAX_TAPS = 27  # 3 x 3 x 3 lattice neighbourhood


def _pad_checks(x: torch.Tensor, corr: torch.Tensor, myp: int, mxp: int,
                n: int, z_layers: int) -> torch.device:
    dev = _require_cuda(x, "pad_stencil")
    if corr.device != dev:
        raise ValueError(f"corr is on {corr.device}, x on {dev}")
    if x.numel() != n or corr.numel() != n:
        raise ValueError(f"vectors must have {n} entries")
    if not corr.is_contiguous():
        raise ValueError("corr must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernel copies it "
                         "in 16-byte vectors)")
    if mxp % 128 or myp % 8:
        raise ValueError(f"padded extents ({myp}, {mxp}) are not "
                         f"multiples of (8, 128)")
    if z_layers < 0:
        raise ValueError(f"z_layers must be >= 0, got {z_layers}")
    return dev


def _pad_launch(A, x, corr, y, mz: int, Z: int, z_layers: int,
                form: Optional[str]) -> None:
    entry = f"ddps_pad_stencil_{_NAME.get(x.dtype)}_{_NAME.get(corr.dtype)}"
    if entry not in PAD_STENCIL.entries:
        raise TypeError(
            f"no kernel for {x.dtype} vectors with {corr.dtype} correction"
        )
    taps, start, quads = A.kernel_tables()
    if not 0 < taps.shape[0] <= _PAD_MAX_TAPS:
        raise ValueError(f"{taps.shape[0]} taps (the kernel takes 1 to 27)")
    mx, my = A.dims[0], A.dims[1]
    dev = x.device
    with torch.cuda.device(dev):
        PAD_STENCIL.launch(
            entry, x.data_ptr(), corr.data_ptr(), y.data_ptr(),
            taps.ctypes.data, taps.shape[0], start.ctypes.data,
            start.size - 1, quads.ctypes.data, mx, my, int(mz), A.myp, A.mxp,
            int(Z), int(z_layers), _stream(dev), form=form,
        )


def pad_stencil_launch(A, x: torch.Tensor, z_layers: int = 0) -> torch.Tensor:
    """Launch the pad-stencil SpMV of a ``PadStencilOperator`` on a CUDA
    vector of its padded space; returns y in ``x``'s dtype.

    ``z_layers``: layers of z each block marches; 0 takes the kernel's
    choice (from the grid and the occupancy).  Only measurements and tests
    of the kernel pass anything else."""
    _pad_checks(x, A.corr, A.myp, A.mxp, A.n_pad, z_layers)
    y = torch.empty_like(x)
    _pad_launch(A, x, A.corr, y, A.dims[2], A.Z, z_layers, None)
    return y


def pad_stencil_window_launch(A, x: torch.Tensor, corr: torch.Tensor,
                              mz: int, out: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Launch the pad-stencil SpMV on one window of a z-slab: ``x`` and
    ``corr`` hold ``Z = x.numel() / (myp * mxp)`` whole layers of the
    padded space (a slab's owned layers between its two halo layers), and
    the product is written for the layers ``1 <= z <= mz`` of the window,
    0 everywhere else (``mz``: the slab's last real layer, at most ``Z -
    2``).  ``A`` supplies the taps (``kernel_tables()``), ``dims`` (mx, my)
    and the padded extents ``myp`` and ``mxp``.  Writes ``out`` (a
    contiguous window of ``x``'s size and dtype) when given; returns y.
    Counted as a launch of the window form (``Kernel.by_form["window"]``)."""
    layer = A.myp * A.mxp
    Z = x.numel() // layer
    _pad_checks(x, corr, A.myp, A.mxp, Z * layer, 0)
    if not 0 <= mz <= Z - 2:
        raise ValueError(f"mz = {mz} outside [0, {Z - 2}] for a window of "
                         f"{Z} layers")
    if out is None:
        out = torch.empty_like(x)
    elif (out.dtype != x.dtype or out.device != x.device
          or out.numel() != x.numel() or not out.is_contiguous()):
        raise ValueError("out must be a contiguous window of x's size, "
                         "dtype and device")
    _pad_launch(A, x, corr, out, mz, Z, 0, "window")
    return out
