"""The benchmark's harness: finds a cell's files by name, runs it once and
builds the result's line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the names in
``BENCHMARK.json``:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives), whose
  ``system`` names the module under ``systems/`` that drives it;
- ``traffic/<mix>.json``, read by the one generator in ``traffic.py``;
- ``cells/<cell>.json``: the limits that decide ``correct``, with the
  readings each was set from;
- ``metrics/<metric>.py``: one reader per per-layer metric,
  ``read(run) -> float | None``.

A run: set-up (the program's build and the kernels' load, counted in
``setup_s`` from the start of the process), a warm-up on the cell's own
shapes, then a closed loop of requests for ``seconds``: one caller, the
next request sent when the last answer is a host array.  Once the window
has closed, the peak device memory is read, the program's state freed,
and the reference judges a sample of the answers drawn from the seed.  A
cell on several cards runs this in step in one process per card
(``group.py``); rank 0 judges and reports.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from . import traffic as traffic_mod
from .tracing import (Spans, mark_fine, profiler, reduce_device,
                      reduce_trace, top)

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "domain_decomposed_pde_solver_tpu")
# Fixed for every cell, so that no traffic mix can change what the
# warm-up covers or shrink what ``correct`` judges.
WARMUP_REQUESTS = 3
CHECK_SAMPLE = 16


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    root = pathlib.Path(root)
    spec = _json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in spec["workloads"]}.get(name)
    if wl is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    cfg = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    config = dict(_json(root / cfg["file"]), name=cfg["name"])
    pkg = root / PKG.name
    mix = _json(pkg / "traffic" / f"{wl['traffic']}.json")
    if mix.get("loop") != "closed" or mix.get("clients") != 1:
        raise ValueError(f"traffic {wl['traffic']!r}: the generator runs one "
                         f"caller in a closed loop")
    return Cell(
        name=name, workload=wl, config=config, traffic=mix,
        limits=_json(pkg / "cells" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )


def load_reader(name: str, root: pathlib.Path = ROOT):
    path = pathlib.Path(root) / PKG.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def peak_bytes_per_s(kind: str) -> Optional[float]:
    peaks = _json(PKG / "peaks.json")
    entry = peaks.get(kind)
    return None if entry is None else float(entry["hbm_bytes_per_s"])


def card_line() -> str:
    """The card's name and power limit from ``nvidia-smi``, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read ({e})"
    return out[0] if out else "nvidia-smi printed no card"


@dataclasses.dataclass
class Record:
    """One request of the window."""
    temps: Dict[int, float]
    ms: float  # handed to the program -> answer on the host
    solve_ms: Optional[float]
    copy_ms: Optional[float]
    iterations: int
    converged: bool


class Sample:
    """The answers the reference judges: a reservoir of ``k`` drawn from the
    seed over the whole window, the answer that took the most iterations,
    and the last one.  Kept answers are copied into buffers made (and
    touched) before the window, so that holding them changes nothing in
    how the program's own arrays are allocated and reused."""

    def __init__(self, k: int, seed: int, like: np.ndarray):
        self.k = k
        self.rng = traffic_mod.rng(seed, traffic_mod.SAMPLE)
        self.bufs = [np.zeros_like(like) for _ in range(k + 1)]
        self.index = [-1] * (k + 1)  # answer held by each buffer; k: hardest
        self.most = -1
        self.last = (-1, None)

    def _keep(self, slot: int, i: int, x: np.ndarray) -> None:
        np.copyto(self.bufs[slot], x)
        self.index[slot] = i

    def offer(self, i: int, x: np.ndarray, iterations: int) -> None:
        j = i if i < self.k else int(self.rng.integers(0, i + 1))
        if j < self.k:
            self._keep(j, i, x)
        if iterations > self.most:
            self.most = iterations
            self._keep(self.k, i, x)
        self.last = (i, x)

    def items(self):
        out = {i: b for i, b in zip(self.index, self.bufs) if i >= 0}
        if self.last[1] is not None:
            out[self.last[0]] = self.last[1]
        return sorted(out.items())


@dataclasses.dataclass
class RunRecord:
    """What a per-layer reader reads."""
    cell: Cell
    records: List[Record]
    window_s: float
    setup: Dict[str, float]  # set-up spans, seconds
    trace: object  # tracing.Trace or None
    fine: Dict[str, str]  # metric family -> kernel whose launches it reads
    facts: Dict[str, int]  # the reference's own counts: n_free, nnz
    peak_bytes_per_s: Optional[float]
    failed: frozenset = frozenset()  # records unconverged or over the limit


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def answer_rate(run: RunRecord) -> float:
    """Answers that came right, over the window's whole length."""
    return (len(run.records) - len(run.failed)) / run.window_s


def answer_p95(run: RunRecord) -> float:
    """95th percentile of every request's time, a failed request counted
    as the window's longest."""
    times = [r.ms for r in run.records]
    worst = max(times)
    return p95([worst if i in run.failed else t
                for i, t in enumerate(times)])


# End-to-end metrics on the host's clock, taken by the harness itself; any
# other end-to-end metric has a reader of its own, as per-layer ones do.
HOST_CLOCK = {"answers_per_s": answer_rate, "answer_ms_p95": answer_p95}


def device_timed(cell: Cell) -> bool:
    """Whether the cell has an end-to-end metric read from the device's
    trace, so that its untraced runs record the device's work too."""
    return any(m["source"] == "device_trace" for m in cell.end_to_end)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def open_device(device):
    """The device, initialised, with its peak memory reset and, on the
    card, the program's kernels built or loaded."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)
        from domain_decomposed_pde_solver_tpu_torch.ops import _kernels

        _kernels.build_kernels()
    return device


def open_session(cell: Cell, device, spans: Spans):
    system = importlib.import_module(
        f"{PKG.name}.systems.{cell.config['system']}")
    return system.setup(cell.config, cell.traffic, device, spans)


def warm_up(session, mix: dict, seed: int, count: int):
    """``count`` requests from the seed's warm-up stream; returns the last
    answer."""
    warm = traffic_mod.requests(mix, seed, traffic_mod.WARMUP)
    ans = None
    for _ in range(count):
        temps = next(warm)
        session.prepare(temps)
        ans = session.request(temps)
    return ans


def closed_loop(session, mix: dict, seed: int, seconds: float,
                spans: Spans, sample: Optional[Sample], side=None):
    """The measured window: requests one after the other until
    ``seconds`` have passed at the end of one, the answers offered to
    ``sample``.  Returns the records and the window's length.

    Across cards (``side``, a ``group.SideGroup``) every rank sends the
    same requests in step; rank 0 alone keeps the records and the sample
    (the others pass ``sample=None`` and keep none) and decides when the
    window has ended, which the side group tells every rank after each
    answer, in the ``client`` span."""
    reqs = traffic_mod.requests(mix, seed, traffic_mod.WINDOW)
    records: List[Record] = []
    with spans.span("window"):
        w0 = time.perf_counter()
        while True:
            temps = next(reqs)
            with spans.span("client"):
                session.prepare(temps)
            t0 = time.perf_counter()
            with spans.span("request"):
                ans = session.request(temps)
            t1 = time.perf_counter()
            ended = t1 - w0 >= seconds
            if sample is not None:
                records.append(Record(temps, (t1 - t0) * 1e3, ans.solve_ms,
                                      ans.copy_ms, ans.iterations,
                                      ans.converged))
                sample.offer(len(records) - 1, ans.x, ans.iterations)
            if side is not None:
                with spans.span("client"):
                    ended = side.ended(ended)
            if ended:
                return records, t1 - w0


def judge(ref, records: List[Record], sample: "Sample",
          transform=None) -> Dict[int, float]:
    """The reference's relative residual of each sampled answer (after
    ``transform``, where a control asks for one)."""
    return {i: ref.relres(x if transform is None else transform(x),
                          records[i].temps)
            for i, x in sample.items()}


class MissingMetrics(RuntimeError):
    """A metric listed for the cell read nothing."""


def read_per_layer(cell: Cell, run: RunRecord, root: pathlib.Path,
                   required: bool, listed=None) -> dict:
    """The cell's per-layer metrics (or the ``listed`` ones) from their
    readers.  A reader that finds nothing returns None and its metric is
    left out; where ``required`` (a traced run on the card), that fails
    the run, naming the metrics on standard error."""
    metrics, missing = {}, []
    for m in cell.per_layer if listed is None else listed:
        v = load_reader(m["name"], root)(run)
        if v is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if missing and required:
        log(f"metrics listed for {cell.name} read nothing: "
            + ", ".join(missing))
        raise MissingMetrics(", ".join(missing))
    return metrics


def card_report(device, mem_peak: int, tr) -> dict:
    """What one rank's card did, for :func:`merge_devices`: its kind and
    index, its peak memory and, in a traced run, its trace's busy time and
    window."""
    import torch

    rep = {"kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "index": device.index, "memory_peak_bytes": int(mem_peak)}
    if tr is not None:
        rep["busy_s"] = tr.busy_s
        rep["window_s"] = tr.window_s
    return rep


def merge_devices(reports: List[dict]) -> dict:
    """The result's ``device`` from every rank's :func:`card_report`, in
    rank order.  ``count`` is the number of distinct cards whose peak
    memory is above zero, so a card that did no work is not counted;
    ``memory_peak_bytes`` is the fullest card's; ``busy_s`` and
    ``window_s``, where every rank traced its window, are means over the
    ranks, so that their ratio is the mean busy share.  The per-rank
    values stand beside them.  Cards of different kinds raise
    ``ValueError``."""
    kinds = sorted({r["kind"] for r in reports})
    if len(kinds) != 1:
        raise ValueError(f"the ranks ran on cards of different kinds: "
                         f"{kinds}")
    peaks = [r["memory_peak_bytes"] for r in reports]
    dev = {"platform": "cpu" if kinds[0] == "cpu" else "gpu",
           "kind": kinds[0],
           "count": len({r["index"] for r in reports
                         if r["memory_peak_bytes"] > 0}),
           "memory_peak_bytes": max(peaks),
           "memory_peak_bytes_per_card": peaks}
    if all("busy_s" in r for r in reports):
        busy = [r["busy_s"] for r in reports]
        dev["busy_s"] = sum(busy) / len(busy)
        dev["window_s"] = sum(r["window_s"] for r in reports) / len(reports)
        dev["busy_s_per_card"] = busy
    return dev


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: pathlib.Path = ROOT,
             side=None) -> Optional[dict]:
    """One run of ``cell``; returns the result's line as a dict.

    Across cards (``side``, a ``group.SideGroup``) every rank runs this in
    step on its own device: the same set-up, warm-up and requests.  Rank 0
    alone logs, keeps the records and ends the window (:func:`closed_loop`);
    once every rank has freed its card and sent its :func:`card_report`,
    rank 0 judges and returns the line, whose ``device`` merges the
    reports, and the others return None."""
    import torch

    from .reference.heat import reference_for

    device = torch.device(device)
    cuda = device.type == "cuda"
    lead = side is None or side.rank == 0
    spans = Spans(tracing=trace and cuda)
    # An untraced run of a cell with an end-to-end metric from the device's
    # trace records the device's work alone, with no host events.
    light = not trace and cuda and device_timed(cell)
    with spans.span("kernels"):
        device = open_device(device)
    session = open_session(cell, device, spans)
    with spans.span("warmup"):
        last = warm_up(session, cell.traffic, seed, WARMUP_REQUESTS)
        sample = Sample(CHECK_SAMPLE, seed, last.x) if lead else None
        fine = {}
        if spans.tracing:
            for kind, kernel, op in session.fine_operators():
                mark_fine(spans, kind, op)
                fine[kind] = kernel
            with profiler():  # the profiler's own first start
                warm_up(session, cell.traffic, seed, 1)
        elif light:
            with profiler(("cuda",)):
                warm_up(session, cell.traffic, seed, 1)
        _sync(device)
        if side is not None:
            side.barrier()
    setup_s = time.perf_counter() - t_start
    setup_spans = dict(spans.totals)
    if lead:
        log(f"set-up {setup_s:.3f} s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in spans.totals.items()))

    prof = (profiler() if spans.tracing else profiler(("cuda",)) if light
            else contextlib.nullcontext())
    with prof as p:
        records, window_s = closed_loop(session, cell.traffic, seed,
                                        seconds, spans, sample, side)
        if light:
            _sync(device)
    mem_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    tr = dev_tr = None
    if spans.tracing:
        t0 = time.perf_counter()
        tr = reduce_trace(p)
    elif light:
        t0 = time.perf_counter()
        dev_tr = reduce_device(p)
        if lead and dev_tr is not None:
            log(f"device trace: busy {dev_tr.busy_s:.4f} s of "
                f"{dev_tr.window_s:.4f} s, reduced in "
                f"{time.perf_counter() - t0:.3f} s")
    if tr is not None and lead:
        log(f"trace: {len(tr.kernels)} kernels in the window, "
            f"reduced in {time.perf_counter() - t0:.3f} s")
        for kind, kernel in fine.items():
            ks = [k.seconds for k, _s in tr.launched_in(f"fine.{kind}.",
                                                        kernel)]
            med = float(np.median(ks)) if ks else 0.0
            log(f"{kind}: {len(ks)} launches of {kernel} inside the fine "
                f"operator's products, device ms min/median/max "
                + (f"{min(ks) * 1e3:.4f}/{med * 1e3:.4f}/{max(ks) * 1e3:.4f}"
                   f"; under half the median: "
                   f"{sorted(round(k * 1e3, 4) for k in ks if k < med / 2)[:20]}"
                   if ks else "-"))

    # The program's state goes before the reference runs.
    ref_mesh = session.reference_mesh() if lead else None
    session.close()
    del session
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    reports = [card_report(device, mem_peak, tr)]
    if side is not None:
        reports = side.finish(reports[0])
        if not lead:
            return None
    t0 = time.perf_counter()
    ref = reference_for(cell.config, mesh=ref_mesh, device=device)
    checked = judge(ref, records, sample)
    log(f"reference: {ref.n_free} free DOF, {ref.nnz} nonzeros; "
        f"{len(checked)} answers of {len(records)} judged in "
        f"{time.perf_counter() - t0:.3f} s")

    limit = float(cell.limits["relres_limit"])
    rejected = {i for i, r in checked.items() if not r <= limit}
    unconverged = {i for i, r in enumerate(records) if not r.converged}
    failed = rejected | unconverged
    relres_max = max(checked.values())
    checks = {
        "relres_max": {"value": relres_max, "limit": limit},
        "unconverged": {"value": len(unconverged), "limit": 0},
    }
    correct = not failed and relres_max <= limit

    dev = merge_devices(reports)
    run = RunRecord(cell, records, window_s, setup_spans,
                    tr if trace else dev_tr, fine,
                    {"n_free": int(ref.n_free), "nnz": int(ref.nnz)},
                    peak_bytes_per_s(dev["kind"]) if cuda else None,
                    frozenset(failed))
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": len(failed)}
    metrics = {}
    if not trace:
        own = [m for m in cell.end_to_end
               if m["name"] != "setup_s" and m["name"] not in HOST_CLOCK]
        read = read_per_layer(cell, run, root, required=cuda, listed=own)
        for m in cell.end_to_end:
            name = m["name"]
            v = (setup_s if name == "setup_s" else HOST_CLOCK[name](run)
                 if name in HOST_CLOCK else None)
            if v is not None:
                metrics[name] = {"value": v, "unit": m["unit"]}
            elif name in read:
                metrics[name] = read[name]
    else:
        metrics = read_per_layer(cell, run, root, required=spans.tracing)
        if tr is not None:
            result["breakdown"] = {"device_ops": top(tr.device_ops),
                                   "idle_gaps": top(tr.idle_by_span)}
    result["metrics"] = metrics
    result["device"] = dev
    its = [r.iterations for r in records]
    log(f"window {window_s:.3f} s: {len(records)} answers, median "
        f"{float(np.median([r.ms for r in records])):.3f} ms, p95 "
        f"{p95([r.ms for r in records]):.3f} ms, iterations {min(its)}-"
        f"{max(its)}; relres of the judged answers "
        + " ".join(f"{i}:{r:.3e}" for i, r in sorted(checked.items())))
    result["checks"] = checks
    return result


def print_result(result: dict) -> None:
    """The compared numbers beside their limits, last on standard error;
    the result's line, last on standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
