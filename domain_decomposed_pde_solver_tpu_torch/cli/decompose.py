"""Partition-visualization driver — the ``ExodusIODecomposeTest`` executable.

A copy of the JAX package's ``cli/decompose.py``, on the host only.
Parity with ``ExodusIODecomposeTest.cpp:5-43``: ``--input/--output/
--partitions`` → read mesh → partition element dual graph → write an Exodus
file with one element block per partition.

Usage::

    python -m domain_decomposed_pde_solver_tpu_torch.cli.decompose \
        --input brick.exo --output decomposed.exo --partitions 4
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input", required=True, help="input Exodus-II mesh")
    ap.add_argument("--output", required=True, help="output Exodus-II file")
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np

    from ..io import read_exodus
    from ..parallel import (
        build_dual_graph,
        partition_mesh_elements,
        partition_stats,
        write_decomposition,
    )

    from ..io import ExodusReadError

    try:
        mesh = read_exodus(args.input)
    except (ExodusReadError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.verbose:
        print(
            f"Title: {mesh.title}\n# of Nodes: {mesh.num_nodes}\n"
            f"# of Elements: {mesh.num_elem}"
        )
    parts = partition_mesh_elements(mesh, args.partitions)
    if args.verbose:
        dual = build_dual_graph(mesh)
        print(partition_stats(dual, parts, args.partitions))
    write_decomposition(args.output, mesh, args.partitions, elem_parts=parts)
    print(
        f"Wrote {args.output}: {len(np.unique(parts))} nonempty partitions "
        f"as element blocks"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
