#!/usr/bin/env python3
"""The readings that a cell's limit on ``correct`` is set from, for a
cell on several cards: ``control.py``'s readings with one process per
card, as ``run.py`` runs such a cell (``group.py``).

    python3 portbench/control_group.py --workload <cell> --seeds 1,2,3 --seconds 10 [--out file.json]

One set-up on every rank, then per seed a warm-up and a closed-loop window
of the cell's own traffic (the program's readings: the sampled answers'
relative residuals), then the same of the control's entry on the same
set-up (``control`` of kind ``entry`` in ``cells/<cell>.json``: the
program's own path in the lower precision).  Every rank sends the same
requests in step; rank 0 keeps the samples, ends each window and judges
them on its card.  Prints one JSON object, as ``control.py`` does.  The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(cell, seeds, seconds, device, side) -> dict:
    """Every rank's part of the readings over ``side`` (a
    ``group.SideGroup``); rank 0 returns them, the others None."""
    from portbench import harness
    from portbench.reference.heat import reference_for
    from portbench.tracing import Spans

    control = cell.limits["control"]
    if control["kind"] != "entry":
        raise ValueError(f"control {control['kind']!r}: control.py takes it")
    lead = side.rank == 0
    spans = Spans(tracing=False)
    device = harness.open_device(device)
    session = harness.open_session(cell, device, spans)
    ref = (reference_for(cell.config, mesh=session.reference_mesh(),
                         device=device) if lead else None)
    mixes = {"program": cell.traffic,
             "control": dict(cell.traffic, **{k: v for k, v in control.items()
                                              if k != "kind"})}
    out = []
    for seed in seeds:
        row = {"seed": seed}
        for key, mix in mixes.items():
            session.use(mix)
            last = harness.warm_up(session, mix, seed,
                                   harness.WARMUP_REQUESTS)
            sample = (harness.Sample(harness.CHECK_SAMPLE, seed, last.x)
                      if lead else None)
            records, _w = harness.closed_loop(session, mix, seed, seconds,
                                              spans, sample, side)
            if lead:
                got = harness.judge(ref, records, sample)
                row[f"{key}_answers"] = len(records)
                row[f"{key}_unconverged"] = sum(not r.converged
                                                for r in records)
                row[f"{key}_min"] = min(got.values())
                row[f"{key}_max"] = max(got.values())
        if lead:
            harness.log(f"seed {seed}: {json.dumps(row)}")
            out.append(row)
    session.close()
    side.barrier()
    if not lead:
        return None
    return {"workload": cell.name, "control": control["kind"],
            "devices": cell.chips, "card": harness.card_line(),
            "lower": max(r["program_max"] for r in out),
            "upper": min(r["control_min"] for r in out), "seeds": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import env

    env.prepare(ROOT)
    import torch
    import torch.distributed as dist

    from portbench import group, harness

    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips or cell.chips < 2:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA cards, "
              f"two or more (one card: control.py)", file=sys.stderr)
        return 2
    devices = [f"cuda:{r}" for r in range(cell.chips)]
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.rank:
        group._leave_with_parent()
        side = group.SideGroup.join(devices[args.rank])
        readings(cell, seeds, args.seconds, devices[args.rank], side)
        dist.destroy_process_group()
        return 0
    harness.log(f"{args.workload} control on {harness.card_line()}")
    harness.open_device(devices[0])  # builds the kernels before the others
    launch = {"DDPS_COORDINATOR": f"localhost:{group.free_port()}",
              "DDPS_NUM_PROCESSES": str(cell.chips)}
    os.environ.update(launch, DDPS_PROCESS_ID="0")
    command = [sys.executable, str(pathlib.Path(__file__).resolve()),
               *(sys.argv[1:] if argv is None else argv)]
    followers = group.Followers(command, cell.chips, dict(os.environ))
    try:
        side = group.SideGroup.join(devices[0])
        res = readings(cell, seeds, args.seconds, devices[0], side)
        dist.destroy_process_group()
        followers.wait(group.TIMEOUT_S)
    except BaseException:
        followers.kill()
        raise
    text = json.dumps(res)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
