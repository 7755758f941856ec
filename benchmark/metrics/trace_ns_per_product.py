"""Layer: air/module.py + native/ (the host trace).  Over the traced
requests, the host ns of the port's `air.trace` spans over the growth of
`tracing.counters["trace_products"]` inside them: the time a Montgomery
product of the trace takes, or, where the trace is bound by its layout and
not by its products, that bound spread over its few products.  None where
the program has no such counter or the spans counted none."""

from benchmark.metrics.prover_build_ms import traced_spans


def read(run):
    spans = traced_spans(run)
    if spans is None:
        return None
    traces = [s for s in spans if s.name == "air.trace"]
    products = sum(s.deltas.get("trace_products", 0) for s in traces)
    if not products:
        return None
    return sum(s.end_ns - s.start_ns for s in traces) / products
