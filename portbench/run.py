#!/usr/bin/env python3
"""Run one cell of the benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints progress and the compared numbers on standard error, and the
result as one JSON line, last on standard output: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, the
device's busy time and a breakdown.  Needs the CUDA cards the cell asks
for; without them it exits non-zero and prints no result.

A cell on K > 1 cards runs as K processes of this script on this host,
one per card (``portbench/group.py``): this one is rank 0 and starts the
others itself, each with ``--rank r``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import env

    env.prepare(ROOT)
    from portbench import harness

    cell = harness.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    devices = [f"cuda:{r}" for r in range(cell.chips)]
    if args.rank:
        if not 0 < args.rank < cell.chips:
            ap.error(f"--rank {args.rank} of a cell on {cell.chips} card(s)")
        from portbench import group

        return group.follow(cell, args.seed, args.seconds, bool(args.trace),
                            devices, args.rank, T_START, ROOT)
    harness.log(f"{args.workload} seed {args.seed} on "
                f"{harness.card_line()}, torch {torch.__version__}")
    if cell.chips == 1:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), devices[0], T_START, ROOT)
    else:
        from portbench import group

        command = [sys.executable, str(pathlib.Path(__file__).resolve()),
                   *(sys.argv[1:] if argv is None else argv)]
        result = group.lead(cell, args.seed, args.seconds, bool(args.trace),
                            devices, T_START, ROOT, command)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the benchmark may not load: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
