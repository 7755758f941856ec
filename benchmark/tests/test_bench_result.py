"""A whole run of each cell on the CPU at toy size: the last line's schema."""

import pytest

from benchmark import run
from benchmark.tests.conftest import toy_cell


@pytest.mark.parametrize("workload", ["mimc128-2p20", "poseidon-merkle-d16"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_schema(workload, trace):
    c = toy_cell(workload)
    res = run.run_cell(c, 2 ** 35 + 1, 0.5, trace, device="cpu", log=lambda line: None)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    wanted = {m["name"]: m["unit"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(res["metrics"]) <= set(wanted)
    for name, m in res["metrics"].items():
        assert m["unit"] == wanted[name] and m["value"] > 0
    if trace:
        assert {"trace_ms", "enqueue_ms", "assemble_ms"} <= set(res["metrics"])
        assert res["device"]["window_s"] > 0
    else:
        assert {"proofs_per_s", "prove_p90_s", "setup_s"} <= set(res["metrics"])
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
