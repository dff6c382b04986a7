"""The roofline readers' byte counts on known shapes, and the trace
reduction's attribution of launches and idle time, on made-up events."""

import types

import pytest

from portbench.metrics import _roofline
from portbench.tracing import KernelEvent, Trace, _idle_by_span, _merge

H100 = 3.35e12


def test_kernel_1_bytes_on_the_833k_operator():
    n, nnz = 833_048, 11_823_058
    b = _roofline.sell_bytes(nnz, n, 4)
    assert b == nnz * 5 + n * 8 == 65_779_674
    assert b / H100 * 1e3 == pytest.approx(0.019636, abs=1e-6)
    assert _roofline.sell_bytes(nnz, n, 8) == nnz * 5 + n * 16


def test_kernel_3_bytes_on_the_10m_box():
    n = 216 * 218 * 218
    assert n == 10_265_184
    assert _roofline.stencil_bytes(n, 4) == 82_121_472
    assert _roofline.stencil_bytes(n, 4) / H100 * 1e3 == pytest.approx(
        0.024514, abs=1e-6)
    assert _roofline.stencil_bytes(n, 8) == 2 * _roofline.stencil_bytes(n, 4)


def _run(kernels, spans, n=800_000, nnz=12_000_000):
    tr = Trace((0, 10**9), kernels, 0, {}, {}, spans)
    return types.SimpleNamespace(trace=tr, fine={"k1": "sell_spmv_kernel"},
                                 peak_bytes_per_s=H100,
                                 facts={"n_free": n, "nnz": nnz})


def test_share_counts_only_launches_inside_the_fine_products():
    least = _roofline.sell_bytes(12_000_000, 800_000, 4) / H100  # seconds
    dur = round(least * 2 * 1e9)  # ns: each launch at half its roofline
    ks = [KernelEvent("sell_spmv_kernel<signed char, float>", 100, 100 + dur,
                      50),
          KernelEvent("sell_spmv_kernel<float, float>", 300, 300 + 9 * dur,
                      250),  # a level's product: launched outside
          KernelEvent("sell_spmv_kernel<signed char, float>", 5000, 5000 + dur,
                      None)]  # no launch call in the trace
    spans = [("fine.k1.4", 40, 60), ("request", 0, 1000)]
    run = _run(ks, spans)
    from portbench.metrics import k1_roofline

    assert k1_roofline.read(run) == pytest.approx(50.0, rel=1e-3)
    run.trace.spans = [("request", 0, 1000)]
    assert k1_roofline.read(run) is None


def test_idle_gaps_go_to_the_innermost_span():
    merged = _merge([(10, 20), (15, 30), (50, 60)])
    assert merged == [[10, 30], [50, 60]]
    spans = [("window", 0, 100), ("request", 5, 90), ("put", 32, 48),
             ("client", 90, 100)]
    idle = _idle_by_span(merged, spans, "window", 0, 100)
    # gaps: 0-10 (before any span opens at 5: mid 5 -> request),
    # 30-50 (mid 40 in put), 60-100 (mid 80 in request)
    assert idle == {"request": (10 + 40) / 1e9, "put": 20 / 1e9}
