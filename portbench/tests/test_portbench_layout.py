"""The benchmark's files: BENCHMARK.json against its contract, and the
harness finding every configuration, traffic mix, cell and per-layer
reader by name, a throwaway entry included."""

import json
import pathlib
import re
import shutil
import statistics
import time

import pytest

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def tiny_root(tmp_path, tet=(6, 6, 6), box=26):
    """A checkout's benchmark files with the two configurations cut to a
    size the CPU runs in seconds."""
    root = tmp_path / "root"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    for name, cells in (("tet833k", list(tet)), ("box10m", [box] * 3)):
        p = root / "portbench" / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c["mesh"]["cells"] = cells
        p.write_text(json.dumps(c))
    return root


def multicard_root(tmp_path, chips, cells=8):
    """A checkout's benchmark files (:func:`tiny_root`) with one more cell,
    ``slab_box.slab`` on ``chips`` cards, for the harness's tests alone:
    its system module (``slab_session.py`` beside this file) drives the
    port's slab CG across processes on a box of ``cells`` cubed cells, one
    slab per rank, f64 Jacobi-CG to 1e-10."""
    root = tiny_root(tmp_path)
    pb = root / "portbench"
    shutil.copy(pathlib.Path(__file__).parent / "slab_session.py",
                pb / "systems" / "slab_session.py")
    faces = {"100": "x = 0 face", "1000": "x = 1 face"}
    (pb / "configs" / "slab_box.json").write_text(json.dumps({
        "system": "slab_session",
        "mesh": {"kind": "box_tet4_lattice", "cells": [cells] * 3,
                 "nodesets": faces}}))
    (pb / "traffic" / "slab.json").write_text(json.dumps({
        "loop": "closed", "clients": 1, "entry": "slab_cg",
        "temperatures": {"100": [100, 1000], "1000": [100, 1000]},
        "tol": 1e-10, "maxiter": 2000}))
    (pb / "cells" / "slab_box.slab.json").write_text(json.dumps({
        "relres_limit": 1e-8, "control": {"kind": "round_float16"}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "slab_box", "source": "a test",
                            "file": "portbench/configs/slab_box.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "slab_box.slab", "config": "slab_box",
                              "traffic": "slab", "chips": chips,
                              "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def chips_refused(workloads) -> list:
    """What breaks the rule the driver holds cells to: ``chips`` is 1 or
    4, and at most max(1, a quarter of the cells rounded down) ask for 4."""
    bad = [f"{w['name']} on {w['chips']} cards" for w in workloads
           if w["chips"] not in (1, 4)]
    fours = sum(w["chips"] == 4 for w in workloads)
    if fours > max(1, len(workloads) // 4):
        bad.append(f"{fours} of {len(workloads)} cells on 4 cards")
    return bad


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["reduced"] == []
        assert (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    assert not chips_refused(SPEC["workloads"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = harness.load_cell(cell, ROOT)
    assert c.traffic["entry"] and c.config["system"]
    assert c.limits["relres_limit"] > 0 and c.limits["control"]["kind"]
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    e2e = {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert callable(harness.load_reader(m["name"], ROOT))
        assert m["moves"] in e2e  # each cell reports what its metrics move
    for m in c.end_to_end:  # the harness's own, or a reader of its own
        assert m["name"] == "setup_s" or m["name"] in harness.HOST_CLOCK \
            or callable(harness.load_reader(m["name"], ROOT))


@pytest.mark.parametrize("chips", [4, 2, 8])
def test_a_throwaway_multicard_cell_under_the_chips_rule(tmp_path, chips):
    root = multicard_root(tmp_path, chips)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    assert bool(chips_refused(spec["workloads"])) == (chips != 4)
    cell = harness.load_cell("slab_box.slab", root)
    assert cell.chips == chips and cell.config["system"] == "slab_session"


@pytest.mark.parametrize("cells,fours,refused", [
    (3, 1, False), (4, 2, True), (8, 2, False), (8, 3, True), (24, 6, False),
    (24, 7, True)])
def test_at_most_a_quarter_of_the_cells_on_four_cards(cells, fours, refused):
    wl = [{"name": f"c{i}", "chips": 4 if i < fours else 1}
          for i in range(cells)]
    assert bool(chips_refused(wl)) == refused


def test_traffic_is_seeded_and_uniform():
    from portbench import traffic

    mix = harness.load_cell("tet833k.sweep", ROOT).traffic
    seed = 2**31 + 77
    a = [next(g) for g in [traffic.requests(mix, seed)] for _ in range(512)]
    b = [next(g) for g in [traffic.requests(mix, seed)] for _ in range(512)]
    assert a == b
    other = traffic.requests(mix, seed + 1)
    assert [next(other) for _ in range(4)] != a[:4]
    for sid in (100, 1000):
        v = sorted(r[sid] for r in a[:256])
        assert 100 <= v[0] and v[-1] <= 1000
        # one value in each of the 256 slices of the range
        assert [int((x - 100) / 900 * 256) for x in v] == list(range(256))
        assert abs(statistics.mean(v) - 550) < 5


def test_a_throwaway_cell_config_mix_and_metric_are_only_added(tmp_path):
    root = tiny_root(tmp_path)
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    cfg = json.loads((pb / "configs" / "tet833k.json").read_text())
    cfg["mesh"]["cells"] = [5, 5, 5]
    (pb / "configs" / "tet_extra.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "sweep.json").read_text())
    mix["temperatures"] = {"100": [200, 300], "1000": [700, 800]}
    (pb / "traffic" / "narrow.json").write_text(json.dumps(mix))
    (pb / "cells" / "tet_extra.narrow.json").write_text(
        (pb / "cells" / "tet833k.sweep.json").read_text())
    (pb / "metrics" / "answers_seen.py").write_text(
        "def read(run):\n    return len(run.records)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tet_extra", "source": "a test",
                            "file": "portbench/configs/tet_extra.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tet_extra.narrow",
                              "config": "tet_extra", "traffic": "narrow",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "answers_seen", "unit": "answers",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "answers_per_s",
                              "workloads": ["tet_extra.narrow"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("tet_extra.narrow", root)
    assert cell.config["mesh"]["cells"] == [5, 5, 5]
    assert [m["name"] for m in cell.per_layer][-1] == "answers_seen"
    out = harness.run_cell(cell, 5, 0.3, True, "cpu", time.perf_counter(),
                           root)
    assert out["correct"] and out["metrics"]["answers_seen"]["value"] >= 1
    for rec_temps in (out["attempted"],):
        assert rec_temps >= 1
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there changed
