"""Sparse formats: host CSR, the sliced-ELL device operator and its CUDA
SpMV kernel, padded ELL, and operator choice."""

from .csr import CSRMatrix, coo_to_csr
from .bsg import BSGMatrix, bsg_from_coo, bsg_from_csr, bsg_spmv, spmv_plain
from .ell import ELLMatrix, ell_from_csr, pad_to, pad_vector, unpad_vector
from .dia import choose_operator

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
    "choose_operator",
]
