"""Build and bind the port's hand-written CUDA kernels.

The sources live in ``csrc/`` and are compiled at first use with ``nvcc``
into a shared library with a plain C interface, loaded through ``ctypes``
(no PyTorch headers, so a build takes seconds).  The library goes to the
repository's ``build/kernels/`` under a name derived from the source's hash,
so an edited source never loads a stale build.  Nothing is compiled or loaded
when this module is imported: the CPU tests import it on machines without
``nvcc``.

Each launch function checks what the kernel cannot check itself (device,
dtype, shape, contiguity), launches on ``torch.cuda.current_stream()``,
raises if ``cudaGetLastError()`` reports a failed launch, and counts its
launches in a plain integer (:attr:`Kernel.launches`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

import torch

__all__ = ["Kernel", "SELL_SPMV", "build_kernels", "kernel_build_dir", "sell_spmv"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SPMV_SRC = _PKG / "csrc" / "spmv.cu"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"


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
    """One CUDA source compiled to one shared library, loaded on demand."""

    def __init__(self, name: str, src: pathlib.Path):
        self.name = name
        self.src = src
        self.launches = 0
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

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
        for fn in ("ddps_sell_spmv_f32_f32", "ddps_sell_spmv_f32_f64",
                   "ddps_sell_spmv_f64_f64"):
            f = getattr(lib, fn)
            f.restype = ctypes.c_int
            f.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ]
        return lib

    def check(self, code: int) -> None:
        if code != 0:
            msg = self.library().ddps_error_string(code).decode()
            raise RuntimeError(f"{self.name} launch failed: {msg} ({code})")


SELL_SPMV = Kernel("sell_spmv", _SPMV_SRC)

_ENTRY = {
    (torch.float32, torch.float32): "ddps_sell_spmv_f32_f32",
    (torch.float32, torch.float64): "ddps_sell_spmv_f32_f64",
    (torch.float64, torch.float64): "ddps_sell_spmv_f64_f64",
}


def build_kernels() -> list:
    """Build (or load) every kernel of the port; returns the kernels."""
    SELL_SPMV.library()
    return [SELL_SPMV]


def sell_spmv(slice_ptr: torch.Tensor, cols: torch.Tensor,
              vals: torch.Tensor, x: torch.Tensor, n_out: int) -> torch.Tensor:
    """Launch the sliced-ELL SpMV on CUDA tensors; returns y (n_out,).

    ``x`` may be shorter than the operator's input space (zero-extended by
    the kernel); columns are int32, ``slice_ptr`` int64 of length
    ``ceil(n_out / 32) + 1``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"sell_spmv launches on CUDA tensors, got {dev}")
    for name, t in (("slice_ptr", slice_ptr), ("cols", cols), ("vals", vals)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D tensor")
    if slice_ptr.dtype != torch.int64 or cols.dtype != torch.int32:
        raise TypeError("slice_ptr must be int64 and cols int32")
    entry = _ENTRY.get((vals.dtype, x.dtype))
    if entry is None:
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
    lib = SELL_SPMV.library()
    y = torch.empty(n_out, dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(
            slice_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            x.data_ptr(), y.data_ptr(), n_out, x.numel(), stream,
        )
    SELL_SPMV.check(code)
    SELL_SPMV.launches += 1
    return y
