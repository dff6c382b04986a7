"""Session API and request glue: megabytes per answer copied between the
host and the card, from the program's counters ``h2d_bytes`` and
``d2h_bytes`` (counted where each copy is made)."""

from portbench.metrics._program import counter


def read(run):
    v = counter(run, "h2d_bytes", "d2h_bytes")
    return None if v is None else v / 1e6
