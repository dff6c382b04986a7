#!/usr/bin/env python3
"""The readings that a cell's limit on ``correct`` is set from, in one
process: one set-up, then per seed a warm-up and a closed-loop window as
in a run (the program's readings: the sampled answers' relative
residuals), then the control's readings on the same seed.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 10 [--out file.json]

The control is named in ``cells/<cell>.json``:

- ``round_float16``: each sampled answer held in float16, the nearest
  precision below float32 (10 mantissa bits; bfloat16's 7 round eight
  times coarser, so what fails float16 fails bfloat16 too; no float16
  solve can do better than its answer rounded there);
- ``entry``: the program's own path in the lower precision (float32 CG in
  place of the float64 refinement), driven on the same set-up.

Prints one JSON object: per seed the program's largest and the control's
smallest residual.  The benchmark's own runs never run this.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(cell, seeds, seconds, device) -> dict:
    import torch

    from portbench import harness
    from portbench.reference.heat import reference_for, round_to_float16
    from portbench.tracing import Spans

    spans = Spans(tracing=False)
    device = harness.open_device(device)
    session = harness.open_session(cell, device, spans)
    ref = reference_for(cell.config, mesh=session.reference_mesh(),
                        device=device)
    control = cell.limits["control"]
    warm = harness.WARMUP_REQUESTS
    out = []
    for seed in seeds:
        last = harness.warm_up(session, cell.traffic, seed, warm)
        sample = harness.Sample(harness.CHECK_SAMPLE, seed, last.x)
        records, _w = harness.closed_loop(
            session, cell.traffic, seed, seconds, spans, sample)
        prog = harness.judge(ref, records, sample)
        row = {"seed": seed, "answers": len(records),
               "unconverged": sum(not r.converged for r in records),
               "program_max": max(prog.values())}
        if control["kind"] == "round_float16":
            ctl = harness.judge(ref, records, sample, round_to_float16)
        elif control["kind"] == "entry":
            mix = dict(cell.traffic, **{k: v for k, v in control.items()
                                        if k != "kind"})
            session.use(mix)
            last = harness.warm_up(session, mix, seed, warm)
            c_sample = harness.Sample(harness.CHECK_SAMPLE, seed, last.x)
            c_rec, _w = harness.closed_loop(
                session, mix, seed, seconds, spans, c_sample)
            ctl = harness.judge(ref, c_rec, c_sample)
            session.use(cell.traffic)
        else:
            raise ValueError(f"unknown control {control['kind']!r}")
        row["control_min"] = min(ctl.values())
        row["control_max"] = max(ctl.values())
        harness.log(f"seed {seed}: {json.dumps(row)}")
        out.append(row)
        del records, sample
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return {"workload": cell.name, "control": control["kind"],
            "lower": max(r["program_max"] for r in out),
            "upper": min(r["control_min"] for r in out), "seeds": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import env

    env.prepare(ROOT)
    from portbench import harness

    cell = harness.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("portbench: control readings need a CUDA card", file=sys.stderr)
        return 2
    harness.log(f"{args.workload} control on {harness.card_line()}")
    res = readings(cell, [int(s) for s in args.seeds.split(",")],
                   args.seconds, "cuda:0")
    text = json.dumps(res)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
