"""On the card, at a small size: a traced run reads the per-layer metrics
from the device trace.  Skips without a card."""

import time

import pytest

from portbench import harness
from test_portbench_layout import tiny_root


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
