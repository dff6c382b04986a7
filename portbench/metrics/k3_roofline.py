"""Kernels (``csrc/pad_stencil.cu``): kernel 3's share of its roofline on
the fine operator's products, f32 and f64 alike, from the device trace."""

from portbench.metrics._roofline import share, stencil_bytes


def read(run):
    n = run.facts["n_free"]
    return share(run, "k3", lambda vb: stencil_bytes(n, vb))
