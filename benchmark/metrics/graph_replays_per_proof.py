"""Layer: protocol/prover.py commit, lcomb and fri (host enqueue).  Per
traced request, the growth of the port's `tracing.counters["graph_replays"]`
over its root spans (`stark.prove`, `stark.serialize`): the proves whose
device work, from the kept inputs to the packed tail, ran as one replay of
the Prover's recorded CUDA graph instead of being enqueued kernel by
kernel.  None where the program has no such counter."""

from benchmark.metrics.prover_build_ms import traced_spans


def read(run):
    spans = traced_spans(run)
    if spans is None:
        return None
    from genstark_tpu_torch import tracing
    if "graph_replays" not in tracing.counters:
        return None
    return sum(s.deltas.get("graph_replays", 0) for s in spans if s.parent is None) \
        / len(run.profile.requests)
