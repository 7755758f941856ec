"""Layer: air/module.py constraint evaluation + protocol/composition.py (the
host enqueue).  Per traced request, the host ms of the port's
`lcomb.constraints` spans (genstark_tpu_torch.tracing), less the `prover.keep`
spans inside them (a new Prover's tables)."""

from benchmark.metrics.prover_build_ms import traced_spans


def read(run):
    spans = traced_spans(run)
    if spans is None:
        return None
    keeps = {}
    for s in spans:
        if s.name == "prover.keep":
            keeps[s.parent] = keeps.get(s.parent, 0) + s.end_ns - s.start_ns
    return sum(s.end_ns - s.start_ns - keeps.get(s.span, 0) for s in spans
               if s.name == "lcomb.constraints") / len(run.profile.requests) / 1e6
