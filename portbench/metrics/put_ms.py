"""Session API and request glue (``put_vector`` of the operators in
``ops/``): milliseconds per answer staging host vectors onto the card,
from the program's spans ``request.put``."""

from portbench.metrics._program import span_ms


def read(run):
    return span_ms(run, "request.put")
