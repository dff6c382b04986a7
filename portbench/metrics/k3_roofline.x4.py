"""Kernels (``csrc/pad_stencil.cu``) on several cards: kernel 3's share of
its roofline on the fine operator's products in rank 0's trace, one
window a card.  Each launch's least bytes are those of one card's share
of the configuration's free rows, ``n_free // chips`` (never the
program's slab layout, so the count is the same whatever the partition:
rank 0's slab, the fullest, holds a little more)."""

from portbench.metrics._roofline import share, stencil_bytes


def read(run):
    n = run.facts["n_free"] // run.cell.chips
    return share(run, "k3", lambda vb: stencil_bytes(n, vb))
