"""Layer: air/module.py + native/ (the host trace).  Per traced request, the
growth of the port's `tracing.counters["trace_products"]` over its root
spans (`stark.prove`, `stark.serialize`): the Montgomery products the
native trace performed, counted per schema at codegen.  None where the
program has no such counter."""

from benchmark.metrics.prover_build_ms import traced_spans


def read(run):
    spans = traced_spans(run)
    if spans is None:
        return None
    from genstark_tpu_torch import tracing
    if "trace_products" not in tracing.counters:
        return None
    return sum(s.deltas.get("trace_products", 0) for s in spans if s.parent is None) \
        / len(run.profile.requests)
