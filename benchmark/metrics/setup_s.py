"""Process start to window start (host clock): imports, the statements,
the port's Stark, the kernel and trace-generator builds on a first run,
and the warm-up proves."""


def read(run):
    return run.setup_s
