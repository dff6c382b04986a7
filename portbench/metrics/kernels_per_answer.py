"""The solver loop's dispatch (``solvers/cg.py``, the V-cycle): device
kernels in the traced window per answer, every kernel whoever launched
it (PyTorch's own and the hand-written ones)."""


def read(run):
    if run.trace is None or not run.trace.kernels or not run.records:
        return None
    return len(run.trace.kernels) / len(run.records)
