"""A cell on several cards, on the CPU: the merge of the ranks' reports,
a run of two processes over gloo that ends correct, and a follower that
fails mid-window ending the run with no result.

Run as a script, this file is one rank of such a run on the devices it is
given (``--devices cpu,cpu``), as ``run.py`` is on the cards; rank 0
starts the others.  ``--fail-rank r --fail-after n`` makes rank r raise
in its n-th request.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

from portbench import group, harness
from test_portbench_layout import multicard_root

ROOT = pathlib.Path(__file__).resolve().parents[2]
H100 = "NVIDIA H100 80GB HBM3"


def _card(index, peak, kind=H100, busy=None):
    rep = {"kind": kind, "index": index, "memory_peak_bytes": peak}
    if busy is not None:
        rep.update(busy_s=busy, window_s=10.0)
    return rep


def test_four_distinct_cards_read_four():
    dev = harness.merge_devices([_card(i, 100 + i, busy=1.0 + i)
                                 for i in range(4)])
    assert dev["platform"] == "gpu" and dev["kind"] == H100
    assert dev["count"] == 4
    assert dev["memory_peak_bytes"] == 103
    assert dev["memory_peak_bytes_per_card"] == [100, 101, 102, 103]
    assert dev["busy_s"] == 2.5 and dev["window_s"] == 10.0
    assert dev["busy_s_per_card"] == [1.0, 2.0, 3.0, 4.0]


def test_four_ranks_on_one_card_read_one():
    assert harness.merge_devices([_card(0, 5)] * 4)["count"] == 1


def test_a_card_that_held_nothing_is_not_counted():
    dev = harness.merge_devices([_card(0, 7), _card(1, 0), _card(2, 9),
                                 _card(3, 8)])
    assert dev["count"] == 3 and dev["memory_peak_bytes"] == 9
    assert dev["memory_peak_bytes_per_card"] == [7, 0, 9, 8]


def test_the_fullest_card_is_reported():
    dev = harness.merge_devices([_card(0, 3), _card(1, 2**36), _card(2, 1)])
    assert dev["memory_peak_bytes"] == 2**36


def test_cards_of_two_kinds_raise():
    with pytest.raises(ValueError, match="different kinds"):
        harness.merge_devices([_card(0, 1), _card(1, 1, kind="NVIDIA A100")])


def test_busy_time_only_where_every_rank_traced():
    dev = harness.merge_devices([_card(0, 1, busy=1.0), _card(1, 1)])
    assert "busy_s" not in dev and "window_s" not in dev


class _Event:
    """One event of a profiler's trace, as ``tracing.reduce_trace`` reads
    it."""

    def __init__(self, name, start, end, device=True, corr=0, span=False):
        import torch

        self._name, self._start, self._dur = name, start, end - start
        self._type = (torch.autograd.DeviceType.CUDA if device
                      else torch.autograd.DeviceType.CPU)
        self._corr, self._span = corr, span

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return self._type

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._span


def test_nccl_ranges_are_not_counted_beside_their_kernels(monkeypatch):
    from portbench import tracing

    events = [
        _Event("pb.window", 0, 1000, device=False, span=True),
        _Event("pb.window", 0, 1000),  # the span's copy on the device
        _Event("nccl:all_gather", 90, 400),  # c10d's range on the device
        _Event("cudaLaunchKernel", 95, 96, device=False, corr=7),
        _Event("ncclDevKernel_AllGather_RING_LL", 100, 400, corr=7),
        _Event("cudaLaunchKernel", 450, 451, device=False, corr=8),
        _Event("vectorized_elementwise_kernel", 500, 600, corr=8),
    ]
    monkeypatch.setattr(tracing, "_events", lambda prof: events)
    tr = tracing.reduce_trace(None)
    assert [k.name for k in tr.kernels] == [
        "ncclDevKernel_AllGather_RING_LL", "vectorized_elementwise_kernel"]
    assert tr.busy_ns == 400 and tr.window_s == 1e-6
    assert set(tr.device_ops) == {"ncclDevKernel_AllGather_RING_LL",
                                  "vectorized_elementwise_kernel"}


def _launch(root, seconds, *extra, timeout=300):
    """Rank 0 of a two-process run on the CPU, as a process of its own."""
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(root), str(ROOT)]))
    t0 = time.monotonic()
    p = subprocess.run(
        [sys.executable, __file__, "--root", str(root), "--workload",
         "slab_box.slab", "--seed", str(2**31 + 21), "--seconds",
         str(seconds), "--devices", "cpu,cpu", *extra],
        capture_output=True, text=True, cwd=root, env=env, timeout=timeout)
    return p, time.monotonic() - t0


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return multicard_root(tmp_path_factory.mktemp("group"), 2)


def test_two_processes_over_gloo_end_correct(root):
    p, _ = _launch(root, 1.0)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    assert out["device"]["platform"] == "cpu"
    assert len(out["device"]["memory_peak_bytes_per_card"]) == 2
    line = [s for s in p.stderr.splitlines() if "answers per rank" in s][-1]
    assert json.loads(line.split(": ", 1)[1]) == [out["attempted"]] * 2
    assert out["checks"]["relres_max"]["value"] <= 1e-8
    pids = [int(s.rsplit("pid ", 1)[1].rstrip(")"))
            for s in p.stderr.splitlines() if "started rank" in s]
    assert len(pids) == 1 and all(_gone(pid) for pid in pids)


def test_a_follower_that_fails_mid_window_ends_the_run(root):
    fail_after = harness.WARMUP_REQUESTS + 3
    p, took = _launch(root, 30.0, "--fail-rank", "1", "--fail-after",
                      str(fail_after))
    assert p.returncode in (1, group.EXIT_RANK_LOST), p.stderr[-3000:]
    assert p.stdout.strip() == ""
    assert "planted fault" in p.stderr
    assert took < group.TIMEOUT_S
    pids = [int(s.rsplit("pid ", 1)[1].rstrip(")"))
            for s in p.stderr.splitlines() if "started rank" in s]
    assert pids and all(_gone(pid) for pid in pids)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--devices", required=True)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--fail-rank", type=int, default=-1)
    ap.add_argument("--fail-after", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    from portbench import env

    root = pathlib.Path(args.root)
    env.prepare(root)
    cell = harness.load_cell(args.workload, root)
    devices = args.devices.split(",")
    if args.rank == args.fail_rank:
        opened = harness.open_session

        def open_session(*a):
            session = opened(*a)
            request, calls = session.request, [0]

            def failing(temps):
                calls[0] += 1
                if calls[0] == args.fail_after:
                    raise RuntimeError("planted fault")
                return request(temps)

            session.request = failing
            return session

        harness.open_session = open_session
    if args.rank:
        return group.follow(cell, args.seed, args.seconds, False, devices,
                            args.rank, t_start, root)
    result = group.lead(cell, args.seed, args.seconds, False, devices,
                        t_start, root, [sys.executable, __file__, *argv])
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
