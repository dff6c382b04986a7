"""Session API and request glue (``get_vector`` of the operators in
``ops/``): milliseconds per answer fetching the answer to the host, from
the program's spans ``request.get``."""

from portbench.metrics._program import span_ms


def read(run):
    return span_ms(run, "request.get")
