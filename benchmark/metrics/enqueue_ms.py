"""Layer: protocol/prover.py's commit, lcomb and fri stages on the host.
Per traced request, the host time of the port's prove.commit + prove.lcomb
+ prove.fri ranges (torch.profiler), in ms."""


def read(run):
    if run.profile is None or not run.profile.requests:
        return None
    return run.profile.stage_ms_per_request(("prove.commit", "prove.lcomb", "prove.fri"))
