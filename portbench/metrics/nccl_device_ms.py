"""Collectives: device milliseconds per answer of the kernels whose name
holds ``nccl`` (the collectives' kernels, their waits for the other cards
included), in rank 0's trace."""


def read(run):
    t = run.trace
    if t is None or not t.kernels or not run.records:
        return None
    ns = sum(k.end_ns - k.start_ns for k in t.kernels
             if "nccl" in k.name.lower())
    return ns / 1e6 / len(run.records)
