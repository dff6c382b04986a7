"""Kernels (``ops/_kernels.py`` -> ``csrc/spmv.cu``): kernel 1's share of
its roofline on the fine operator's products, from the device trace."""

from portbench.metrics._roofline import sell_bytes, share


def read(run):
    n, nnz = run.facts["n_free"], run.facts["nnz"]
    return share(run, "k1", lambda vb: sell_bytes(nnz, n, vb))
