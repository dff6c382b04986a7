"""The DIA product: kernel 4 of the port and its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/dia_kernel.py``
(``dia_spmv_pallas``), which computes exactly ``DIAMatrix.matvec``:

    y[i] = sum_d  data[d, i] * x[i + offsets[d]],   x read as 0 outside [0, n_pad)

On a CUDA tensor :func:`dia_spmv` launches the hand-written kernel
(``csrc/dia_spmv.cu`` through :mod:`._kernels`) or raises; on a CPU tensor
it evaluates :func:`dia_matvec_plain`, JAX's window-slice sum over an
edge-padded ``x`` with a pairwise tree over the diagonals.
"""

from __future__ import annotations

import torch

__all__ = ["dia_matvec_plain", "dia_spmv"]


def _check(A, x: torch.Tensor) -> None:
    if x.dim() != 1 or x.numel() != A.n_pad:
        raise ValueError(
            f"DIA matvec takes a ({A.n_pad},) vector, got {tuple(x.shape)}"
        )
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported vector dtype {x.dtype}")
    if A.data.dtype == torch.float64 and x.dtype != torch.float64:
        raise TypeError("float64-stored operator needs float64 vectors")
    if x.device != A.device:
        raise ValueError(f"x is on {x.device}, the operator on {A.device}")


def dia_matvec_plain(A, x_padded: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch DIA product: one window of the zero-extended ``x`` per
    diagonal, coefficient upcast to ``x``'s dtype, pairwise sum."""
    _check(A, x_padded)
    h_neg = max(0, -min(A.offsets))
    h_pos = max(0, max(A.offsets))
    x_ext = torch.nn.functional.pad(x_padded, (h_neg, h_pos))
    n = A.n_pad
    terms = [
        A.data[d].to(x_padded.dtype) * x_ext[h_neg + off : h_neg + off + n]
        for d, off in enumerate(A.offsets)
    ]
    while len(terms) > 1:
        pairs = [a + b for a, b in zip(terms[::2], terms[1::2])]
        if len(terms) % 2:
            pairs.append(terms[-1])
        terms = pairs
    return terms[0]


def dia_spmv(A, x_padded: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a :class:`.dia.DIAMatrix`.

    A CUDA tensor goes to the hand-written kernel (which raises on
    failure); a CPU tensor to :func:`dia_matvec_plain`."""
    if x_padded.device.type == "cpu":
        return dia_matvec_plain(A, x_padded)
    _check(A, x_padded)
    if x_padded.device.type != "cuda":
        raise ValueError(f"no DIA product for device {x_padded.device}")
    from ._kernels import dia_spmv_launch

    return dia_spmv_launch(A.data, A.offsets_array, x_padded.contiguous())
