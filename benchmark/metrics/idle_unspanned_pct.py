"""Layer: the card, by program span.  The share of the traced window (the
first traced request's start to the last one's end) in which no operation
runs on the device (torch.profiler) and the host is in no span of the port
(genstark_tpu_torch.tracing) other than the whole prove, `stark.prove`: the
card's idle time that no layer's span accounts for."""

from benchmark.metrics.prover_build_ms import traced_spans


def read(run):
    spans = traced_spans(run)
    if spans is None or not run.profile.device:
        return None
    w0, w1 = run.profile.window
    covered = sorted(run.profile.busy_intervals()
                     + [(max(s.start_ns, w0), min(s.end_ns, w1)) for s in spans
                        if s.name != "stark.prove"])
    total, at = 0, w0
    for s, e in covered:
        if e > at:
            total += e - max(s, at)
            at = e
    return 100.0 * (1.0 - total / (w1 - w0))
