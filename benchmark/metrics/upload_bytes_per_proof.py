"""Layer: protocol/prover.py commit, lcomb and fri (host enqueue).  Per
traced request, the growth of the port's `tracing.counters["upload_bytes"]`
over its root spans (`stark.prove`, `stark.serialize`): the bytes of every
host-to-device copy (`DeviceField.from_numpy`, `tracing.upload`).  None
where the program has no such counter."""

from benchmark.metrics.prover_build_ms import traced_spans


def read(run):
    spans = traced_spans(run)
    if spans is None:
        return None
    from genstark_tpu_torch import tracing
    if "upload_bytes" not in tracing.counters:
        return None
    return sum(s.deltas.get("upload_bytes", 0) for s in spans if s.parent is None) \
        / len(run.profile.requests)
