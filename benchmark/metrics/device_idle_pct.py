"""Layer: the card.  The share of the traced window in which no operation
ran on the device, from torch.profiler's trace of the traced requests (the
window from the first request's start to the last one's end)."""


def read(run):
    if run.profile is None or not run.profile.requests or not run.profile.device:
        return None
    return 100.0 * (1.0 - run.profile.busy_ns() / run.profile.window_ns())
