"""Device: milliseconds per answer in which a kernel, copy or fill runs on
the card (the union of the device's intervals over the window), from a
trace of the device's activity alone, so that the host's speed, which
sets how long the card waits between launches, does not enter it."""


def read(run):
    t = run.trace
    if t is None or t.busy_ns <= 0 or not run.records:
        return None
    return t.busy_s * 1e3 / len(run.records)
