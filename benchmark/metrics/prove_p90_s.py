"""The 90th percentile of every completed request's time in the window
(host clock, prove through serialize), statistics.quantiles' inclusive
method."""

import statistics


def read(run):
    if len(run.durations) < 2:
        return run.durations[0] if run.durations else None
    return statistics.quantiles(run.durations, n=10, method="inclusive")[8]
