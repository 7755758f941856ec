"""Layer: protocol/stark.py `_prover` + `Prover._keep` (a new Prover).  Per
traced request, the host ms inside the port's `prover.new` or `prover.keep`
spans (genstark_tpu_torch.tracing; the union of their intervals), over the
requests whose root span starts inside a traced `bench.request`."""


def traced_spans(run):
    """The program's spans of the traced requests, or None (no profile, or a
    program without spans)."""
    if run.profile is None or not run.profile.requests:
        return None
    try:
        from genstark_tpu_torch import tracing
    except ImportError:
        return None
    spans = tracing.recorded()
    inside = {s.request for s in spans if s.parent is None
              and any(a <= s.start_ns <= b for a, b in run.profile.requests)}
    return [s for s in spans if s.request in inside] or None


def read(run):
    spans = traced_spans(run)
    if spans is None:
        return None
    total, at = 0, None
    for s in sorted((s for s in spans if s.name in ("prover.new", "prover.keep")),
                    key=lambda s: s.start_ns):
        start = s.start_ns if at is None else max(s.start_ns, at)
        total += max(0, s.end_ns - start)
        at = s.end_ns if at is None else max(at, s.end_ns)
    return total / len(run.profile.requests) / 1e6
