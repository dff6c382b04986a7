"""``chip_smoke.py`` phase K on the CPU: every port example run twice
(the card's run and the ``--cpu`` run both on the CPU here) and held to
itself by the smoke's rule, 06's count the same at every P, and the five
``ddps-torch-*`` console scripts resolved from ``pyproject.toml`` and
called as their installed wrappers call them, on a 20^3 box."""

import tempfile

import torch

import chip_smoke
from domain_decomposed_pde_solver_tpu_torch.ops import _kernels


def test_phase_k_on_the_cpu(tmp_path, monkeypatch):
    # The examples' files go to the temporary directory: this test's own.
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    run = chip_smoke.phase_k(torch.device("cpu"), _kernels.KERNELS,
                             dict(b_iterations=None), out=tmp_path)
    assert sorted(run["examples"]) == sorted(chip_smoke.EXAMPLES)
    assert sorted(run["console"]) == sorted(chip_smoke.console_scripts())
    assert all(r["rc"] == 0 for r in run["console"].values())
    assert run["console"]["ddps-torch-solve"]["iterations"] > 0
    for name in chip_smoke.REPLACES:
        assert set(chip_smoke.phase_k_launches(run, name).values()) == {0}
