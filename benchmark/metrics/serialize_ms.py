"""Layer: protocol/serializer.py.  Per traced request, the host ms of the
port's `stark.serialize` spans (genstark_tpu_torch.tracing)."""

from benchmark.metrics.prover_build_ms import traced_spans


def read(run):
    spans = traced_spans(run)
    if spans is None:
        return None
    return sum(s.end_ns - s.start_ns for s in spans if s.name == "stark.serialize") \
        / len(run.profile.requests) / 1e6
