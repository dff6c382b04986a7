"""Output combiner driver — the ``mpi_output_combiner.py`` equivalent.

A copy of the JAX package's ``cli/combine.py``, on the host only.  Merges
per-part ``$PREFIX$PART.out`` debug dumps into one ordered stream
(section-header validation + tag-ordered merge, ``mpi_output_combiner.py:
19-78``).

Usage::

    python -m domain_decomposed_pde_solver_tpu_torch.cli.combine \
        --prefix mpi-proc- --output combined.out
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prefix", required=True, help="per-part file prefix")
    ap.add_argument("--output", required=True, help="merged output file")
    args = ap.parse_args(argv)

    from ..utils import combine_outputs

    combine_outputs(args.prefix, args.output)
    print(f"Wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
