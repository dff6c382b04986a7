"""On the card, at a small size: a traced run reads the per-layer metrics
from the device trace, and a cell on every card present (up to four) runs
one process per card and counts them.  Skips without the cards."""

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

from portbench import harness
from test_portbench_layout import multicard_root, tiny_root

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("cell,kernel", [("tet833k.sweep", "k1_roofline"),
                                         ("box10m.cg", "k3_roofline")])
def test_traced_run_on_the_card(card, tmp_path, cell, kernel):
    root = tiny_root(tmp_path, tet=(20, 20, 20), box=40)
    out = harness.run_cell(harness.load_cell(cell, root), 7, 1.0, True, card,
                           time.perf_counter(), root)
    assert out["correct"]
    m = out["metrics"]
    assert 0 < m[kernel]["value"] <= 105
    assert 0 <= m["device_idle"]["value"] < 100
    assert m["kernels_per_answer"]["value"] > 0
    assert out["device"]["busy_s"] > 0 and out["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_on_several_cards_counts_them(tmp_path, trace):
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        pytest.skip("needs two CUDA cards or more")
    k = min(cards, 4)
    root = multicard_root(tmp_path, k, cells=40)
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "slab_box.slab",
         "--seed", str(2**31 + 5), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, cwd=root, timeout=1200,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == 0, p.stderr[-4000:]
    line = p.stdout.strip().splitlines()[-1]
    print(line)
    out = json.loads(line)
    dev = out["device"]
    assert out["correct"] and out["attempted"] >= 1
    assert dev["platform"] == "gpu" and dev["count"] == k
    assert dev["kind"] == torch.cuda.get_device_name(0)
    peaks = dev["memory_peak_bytes_per_card"]
    assert len(peaks) == k and min(peaks) > 0
    assert dev["memory_peak_bytes"] == max(peaks)
    if trace:
        busy = dev["busy_s_per_card"]
        assert len(busy) == k and min(busy) > 0
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert out["breakdown"]["device_ops"]
