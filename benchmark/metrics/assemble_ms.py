"""Layer: protocol/prover.py's assembly of the proof on the host.  Per
traced request, the host time of the port's prove.assemble range
(torch.profiler), in ms."""


def read(run):
    if run.profile is None or not run.profile.requests:
        return None
    return run.profile.stage_ms_per_request(("prove.assemble",))
