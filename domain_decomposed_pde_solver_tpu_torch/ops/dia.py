"""Operator choice for the port: every matrix goes to the sliced-ELL kernel.

Counterpart of the JAX package's ``ops/dia.py::choose_operator``.  The JAX
function picks among five TPU formats (lattice stencil, pad-stencil, DIA,
BSG, Split-ELL/ELL).  In this slice of the port every matrix goes to the
port's unstructured operator (:class:`.bsg.BSGMatrix`, sliced ELL, the
hand-written SpMV kernel), including the matrices JAX sends to Split-ELL or
HYB — TPU gather-avoidance formats that a GPU does not need.  The DIA,
lattice-stencil and pad-stencil routes, and with them the JAX arguments
that select them (``grid_dims``, ``max_diags``, ``pad_stencil``), come with
the structured slice (``ROADMAP.md``, Queue 1, item 7).
"""

from __future__ import annotations

import torch

from .bsg import bsg_from_csr
from .csr import CSRMatrix

__all__ = ["choose_operator"]


def choose_operator(
    csr: CSRMatrix,
    dtype=torch.float32,
    bsg: str = "never",
    device=None,
):
    """Build the device operator for ``csr``.

    - ``bsg="auto"`` or ``"always"``: the JAX BSG route — RCM-permuted
      internal space, padded to a multiple of 1024 rows, float32
      coefficients (exact for the graph Laplacian).  JAX takes it only for
      f32 on a TPU because its BSG computes in f32; the port's kernel also
      computes in f64, so the port takes it at either dtype.
    - ``bsg="never"``: the identity (original-order) space that JAX's DIA
      and ELL formats use, with coefficients stored in ``dtype`` as those
      formats store them — what the AMG hierarchy asks for on its coarse
      levels.
    """
    if bsg not in ("never", "auto", "always"):
        raise ValueError(f"bsg must be never|auto|always, got {bsg!r}")
    if bsg != "never":
        return bsg_from_csr(csr, device=device)
    storage = "float64" if dtype == torch.float64 else "float32"
    return bsg_from_csr(csr, reorder=False, storage=storage, device=device)
