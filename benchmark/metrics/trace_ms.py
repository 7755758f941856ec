"""Layer: air/module.py + native/ (the host trace).  The mean over the
window's proofs of the port's `Stark.last_context.trace_seconds`, in ms."""


def read(run):
    values = [s for s in run.trace_seconds if s is not None]
    return sum(values) / len(values) * 1e3 if values else None
