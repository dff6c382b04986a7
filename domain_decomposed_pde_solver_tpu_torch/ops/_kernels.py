"""Build and bind the port's hand-written CUDA kernels.

The sources live in ``csrc/`` and are compiled at first use with ``nvcc``
into shared libraries with a plain C interface, loaded through ``ctypes``
(no PyTorch headers, so a build takes seconds).  The libraries go to the
repository's ``build/kernels/`` under names derived from each source's
hash, so an edited source never loads a stale build.  Nothing is compiled
or loaded when this module is imported: the CPU tests import it on machines
without ``nvcc``.  :func:`build_kernels` starts one ``nvcc`` per source,
all at once.

Each launch function checks what the kernel cannot check itself (device,
dtype, shape, contiguity), launches on ``torch.cuda.current_stream()``,
raises if ``cudaGetLastError()`` reports a failed launch, and counts its
launches in plain integers: :attr:`Kernel.launches` in all, and
:attr:`Kernel.by_entry` per C entry point (one per instantiation).
"""

from __future__ import annotations

import ctypes
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
    "DIA_SPMV",
    "Kernel",
    "PAD_STENCIL",
    "SELL_SPMV",
    "build_kernels",
    "dia_spmv_launch",
    "kernel_build_dir",
    "pad_stencil_launch",
    "sell_spmv",
]

_PKG = pathlib.Path(__file__).resolve().parents[1]
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int


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

    ``entries`` maps each C entry point to its ctypes argument types; every
    entry returns an ``int`` (a ``cudaError_t``)."""

    def __init__(self, name: str, src: pathlib.Path,
                 entries: Dict[str, Sequence]):
        self.name = name
        self.src = src
        self.entries = dict(entries)
        self.launches = 0
        self.by_entry: Dict[str, int] = {e: 0 for e in self.entries}
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def reset(self) -> None:
        """Set every launch count to 0."""
        self.launches = 0
        self.by_entry = {e: 0 for e in self.entries}

    def library(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
            return self._lib

    def _build_and_load(self) -> ctypes.CDLL:
        digest = hashlib.sha256(self.src.read_bytes()).hexdigest()[:16]
        out_dir = kernel_build_dir()
        so = out_dir / f"lib{self.name}-{digest}.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [
                _nvcc(), _ARCH, "-std=c++17", "-O3", "-shared",
                "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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

    def launch(self, entry: str, *args) -> None:
        """Call ``entry``, raise on a failed launch, count it."""
        code = getattr(self.library(), entry)(*args)
        if code != 0:
            msg = self.library().ddps_error_string(code).decode()
            raise RuntimeError(f"{self.name} launch failed: {msg} ({code})")
        self.launches += 1
        self.by_entry[entry] += 1


_SELL_ARGS = [_P] * 5 + [_I64, _I64, _P]
SELL_SPMV = Kernel("sell_spmv", _PKG / "csrc" / "spmv.cu", {
    "ddps_sell_spmv_f32_f32": _SELL_ARGS,
    "ddps_sell_spmv_f32_f64": _SELL_ARGS,
    "ddps_sell_spmv_f64_f64": _SELL_ARGS,
})

# data, offsets (host int64), ndiags, x, y, n, stream
_DIA_ARGS = [_P, _P, _INT, _P, _P, _I64, _P]
DIA_SPMV = Kernel("dia_spmv", _PKG / "csrc" / "dia_spmv.cu", {
    "ddps_dia_spmv_bf16_f32": _DIA_ARGS,
    "ddps_dia_spmv_f32_f32": _DIA_ARGS,
    "ddps_dia_spmv_bf16_f64": _DIA_ARGS,
    "ddps_dia_spmv_f32_f64": _DIA_ARGS,
    "ddps_dia_spmv_f64_f64": _DIA_ARGS,
})

# x, corr, y, taps (host int32 (n_taps, 3)), n_taps, group_start (host
# int32), n_groups, quads (host f32), mx, my, mz, myp, mxp, Z, stream
_PAD_ARGS = [_P, _P, _P, _P, _INT, _P, _INT, _P] + [_INT] * 6 + [_P]
PAD_STENCIL = Kernel("pad_stencil", _PKG / "csrc" / "pad_stencil.cu", {
    "ddps_pad_stencil_f32_bf16": _PAD_ARGS,
    "ddps_pad_stencil_f32_f32": _PAD_ARGS,
    "ddps_pad_stencil_f64_bf16": _PAD_ARGS,
    "ddps_pad_stencil_f64_f32": _PAD_ARGS,
})

KERNELS = (SELL_SPMV, PAD_STENCIL, DIA_SPMV)

_NAME = {torch.bfloat16: "bf16", torch.float32: "f32", torch.float64: "f64"}


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


_DIA_MAX_DIAGS = 128  # the kernel's parameter block holds this many offsets


def dia_spmv_launch(data: torch.Tensor, offsets: Sequence[int],
                    x: torch.Tensor) -> torch.Tensor:
    """Launch the DIA SpMV on CUDA tensors; returns y (n_pad,).

    ``data`` is (ndiags, n_pad), contiguous, bf16/f32 storage with f32 or
    f64 vectors or f64 storage with f64 vectors; ``offsets`` are host ints
    (at most 128)."""
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
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    y = torch.empty(n, dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        DIA_SPMV.launch(
            entry, data.data_ptr(), offs.ctypes.data, nd, x.data_ptr(),
            y.data_ptr(), n, _stream(dev),
        )
    return y


_PAD_MAX_TAPS = 27  # 3 x 3 x 3 lattice neighbourhood


def pad_stencil_launch(A, x: torch.Tensor) -> torch.Tensor:
    """Launch the pad-stencil SpMV of a ``PadStencilOperator`` on a CUDA
    vector of its padded space; returns y in ``x``'s dtype."""
    dev = _require_cuda(x, "pad_stencil")
    corr = A.corr
    if corr.device != dev:
        raise ValueError(f"corr is on {corr.device}, x on {dev}")
    if x.numel() != A.n_pad or corr.numel() != A.n_pad:
        raise ValueError(f"vectors must have {A.n_pad} entries")
    if not corr.is_contiguous():
        raise ValueError("corr must be contiguous")
    if A.mxp % 32 or A.myp % 8:
        raise ValueError(f"padded extents ({A.myp}, {A.mxp}) are not "
                         f"multiples of (8, 32)")
    entry = f"ddps_pad_stencil_{_NAME.get(x.dtype)}_{_NAME.get(corr.dtype)}"
    if entry not in PAD_STENCIL.entries:
        raise TypeError(
            f"no kernel for {x.dtype} vectors with {corr.dtype} correction"
        )
    taps, start, quads = A.kernel_tables()
    if not 0 < taps.shape[0] <= _PAD_MAX_TAPS:
        raise ValueError(f"{taps.shape[0]} taps (the kernel takes 1 to 27)")
    mx, my, mz = A.dims
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        PAD_STENCIL.launch(
            entry, x.data_ptr(), corr.data_ptr(), y.data_ptr(),
            taps.ctypes.data, taps.shape[0], start.ctypes.data,
            start.size - 1, quads.ctypes.data, mx, my, mz, A.myp, A.mxp,
            A.Z, _stream(dev),
        )
    return y
