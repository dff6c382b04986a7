"""Assembly smoke-test driver — the ``ExodusAssembleTest`` executable.

A copy of the JAX package's ``cli/assemble_test.py``, on the host only.
Parity with ``ExodusAssembleTest.cpp:4-40``: open → assemble → exit status.

Usage::

    python -m domain_decomposed_pde_solver_tpu_torch.cli.assemble_test --input mesh.exo
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from ..io import read_exodus
    from ..models import assemble_heat_system

    try:
        mesh = read_exodus(args.input)
        system = assemble_heat_system(mesh)
    except Exception as e:  # noqa: BLE001 — smoke test reports any failure
        print(f"FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    if args.verbose:
        print(
            f"nodes={mesh.num_nodes} elems={mesh.num_elem} "
            f"free={system.n_free} nnz={system.A.nnz}"
        )
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
