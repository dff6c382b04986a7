"""Phase M of ``chip_smoke.py`` (the drivers across processes) on the CPU
at small sizes: the CLI's ``--partitions 4`` routes under torchrun, two
processes over gloo with ``--cpu``, on a refined 6^3 tet box (M1, the
halo AMG route) and a 8 x 6 x 92 box (M2, the f64 refinement over four
pad-stencil slabs, kernel 3's plain version), held to the same command
line in one process.

The smoke's own checks run as on the card (the launch counts are the
card's only): the one-process counts and answer bit for bit, process 0
alone opening the solution file and printing, the host relres within
H1's and I1's limits; NCCL is not run without a card per process.
"""

import json

import pytest
import torch

import chip_smoke

CFG = dict(cells=6, box=(8, 6, 92), box_exo="box8x6x92.exo")


@pytest.fixture(scope="module")
def run_m(tmp_path_factory):
    out = tmp_path_factory.mktemp("phase_m")
    return chip_smoke.phase_m(torch.device("cpu"), cfg=CFG, out=out)


def test_phase_m_passes_its_checks_on_the_cpu(run_m):
    json.dumps(run_m)  # what the smoke's record line prints of it
    assert run_m["nccl"] == dict(run=False, cards=0)
    for tag in ("M1", "M2"):
        w = run_m[tag]["workers"]
        assert [r["rank"] for r in w] == [0, 1]
        for r in w:
            assert (r["backend"], r["device"]) == ("gloo", "cpu")
            assert r["iterations"] == run_m[tag]["one_process"]["iterations"]
            assert r["peak_rss_mb"] > 0
        assert w[0]["host_relres"] <= (2e-6 if tag == "M1" else 1.5e-8)
    m2 = run_m["M2"]
    assert m2["workers"][1]["sweeps"] == m2["one_process"]["sweeps"] >= 1


def test_phase_m_records_each_process_launches(run_m):
    got = chip_smoke.phase_m_launches(run_m, "sell_spmv")
    assert sorted(got) == ["M1 rank 0", "M1 rank 1", "M2 rank 0",
                           "M2 rank 1"]
    assert set(got.values()) == {0}  # the plain versions on the CPU
