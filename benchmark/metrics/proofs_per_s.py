"""Proofs completed in the window over the window's seconds (host clock):
the window runs from its start to the end of the last request begun
before its deadline."""


def read(run):
    return run.completed / run.window_s if run.completed else None
