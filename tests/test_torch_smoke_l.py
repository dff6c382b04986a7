"""``chip_smoke.py`` phase L on the CPU at a small size: HYB and Split-ELL
on a refined 10^3 box (products against their plain versions and a host
f64 CSR product, Jacobi-PCG on each against its own host limit), the
AMG's options (the Jacobi smoother, two V-cycles, the BSG chain's
opt-outs) and the build cache's directory switch, which builds nothing
here.  The checks against paths C and D1 only run inside the whole smoke
on the card."""

import torch

import chip_smoke
from domain_decomposed_pde_solver_tpu_torch.ops import _kernels
from domain_decomposed_pde_solver_tpu_torch.utils import compilecache


def test_phase_l_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(compilecache, "_chosen", compilecache._chosen)
    run = chip_smoke.phase_l(torch.device("cpu"), _kernels.KERNELS, {},
                             cells=10, out=tmp_path)
    l1, l2 = run["L1"], run["L2"]
    assert l1["ndiags"] > 0 and 0 < l1["coverage"] < 1
    assert l1["k_star"] > 0 and l1["tail"] > 0
    for label in ("hyb", "splitell"):
        assert l1[label]["host_relres"] <= l1[label]["limit"]
    assert abs(l1["hyb"]["iterations"] - l1["splitell"]["iterations"]) <= 2
    assert set(l2) == {"default", "jacobi", "opt_outs", "opt_outs_auto",
                       "cycles2"}
    assert l2["cycles2"]["iterations"] <= l2["default"]["iterations"]
    assert run["L3"]["built"] == []
    assert max(run["host_errs"].values()) < 1e-3
    for name in chip_smoke.REPLACES:
        assert set(chip_smoke.phase_l_launches(run, name).values()) == {0}
