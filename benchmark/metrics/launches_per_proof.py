"""Layer: kernels.py's launch wrappers.  The growth of the port's
`kernels.launch_counts` over the window, per completed proof."""


def read(run):
    if not run.completed or run.launch_delta is None:
        return None
    total = sum(run.launch_delta.values())
    return total / run.completed if total else None
