"""Sparse formats: host CSR, the sliced-ELL, DIA and lattice-stencil
device operators with their CUDA kernels, padded ELL and its product, RCM
reordering, and operator choice."""

from .csr import CSRMatrix, coo_to_csr
from .bsg import BSGMatrix, bsg_from_coo, bsg_from_csr, bsg_spmv, spmv_plain
from .ell import ELLMatrix, ell_from_csr, pad_to, pad_vector, unpad_vector
from .spmv import ell_spmv, spmv_bytes
from .reorder import rcm_permute
from .dia import DIAMatrix, choose_operator, dia_from_csr, operator_bytes
from .stencil import (
    StencilOperator,
    stencil_from_csr,
    stencil_from_dia,
    stencil_from_packed,
    stencil_from_parts,
    stencil_parts_from_packed,
)
from .stencil_kernel import PadStencilOperator, pad_stencil_from_parts

__all__ = [
    "CSRMatrix",
    "coo_to_csr",
    "BSGMatrix",
    "bsg_from_coo",
    "bsg_from_csr",
    "bsg_spmv",
    "spmv_plain",
    "ELLMatrix",
    "ell_from_csr",
    "pad_to",
    "pad_vector",
    "unpad_vector",
    "ell_spmv",
    "spmv_bytes",
    "rcm_permute",
    "DIAMatrix",
    "choose_operator",
    "dia_from_csr",
    "operator_bytes",
    "StencilOperator",
    "stencil_from_csr",
    "stencil_from_dia",
    "stencil_from_packed",
    "stencil_from_parts",
    "stencil_parts_from_packed",
    "PadStencilOperator",
    "pad_stencil_from_parts",
]
