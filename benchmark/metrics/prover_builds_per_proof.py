"""Layer: protocol/stark.py `_prover` (a new Prover).  Per traced request,
the port's `prover.new` spans (genstark_tpu_torch.tracing): the Provers a
request built."""

from benchmark.metrics.prover_build_ms import traced_spans


def read(run):
    spans = traced_spans(run)
    if spans is None:
        return None
    return sum(s.name == "prover.new" for s in spans) / len(run.profile.requests)
