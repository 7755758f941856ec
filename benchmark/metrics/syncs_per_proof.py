"""Layer: the host's waits for the card in protocol/prover.py and
protocol/stark.py.  Per traced request, the growth of the port's
`tracing.counters["syncs"]` over its root spans (`stark.prove`,
`stark.serialize`): each fetch to the host and each upload from pageable
memory."""

from benchmark.metrics.prover_build_ms import traced_spans


def read(run):
    spans = traced_spans(run)
    if spans is None:
        return None
    return sum(s.deltas.get("syncs", 0) for s in spans if s.parent is None) \
        / len(run.profile.requests)
