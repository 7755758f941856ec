"""The port's spans and sync counter (genstark_tpu_torch.tracing) on a toy
AIR on the CPU, and the benchmark's readers of them (benchmark/metrics/)."""

import collections
import itertools
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import cells
from benchmark.run import Run
from benchmark.trace import Profile
from genstark_tpu_torch import instantiate_script, tracing
from genstark_tpu_torch.protocol import Assertion

SOURCE = """
define Foo over prime field (2^32 - 3 * 2^25 + 1) {
    secret input startValue: element[1];
    transition 1 register {
        for each (startValue) {
            init { yield startValue; }
            for steps [1..63] { yield $r0 + 2; }
        }
    }
    enforce 1 constraint {
        for all steps { enforce transition($r) = $n; }
    }
}"""
OPTIONS = {"extension_factor": 8, "exe_query_count": 8, "fri_query_count": 6}
# name -> the names its parent may have (None: a root)
PARENTS = {
    "stark.prove": {None}, "stark.serialize": {None},
    "stark.context": {"stark.prove"}, "air.trace": {"stark.prove"},
    "stark.assertions": {"stark.prove"}, "stark.prover": {"stark.prove"},
    "prover.new": {"stark.prover"}, "prove.upload": {"stark.prove"},
    "prove.commit": {"stark.prove"}, "prove.lcomb": {"stark.prove"},
    "prove.fri": {"stark.prove"}, "prove.tail": {"stark.prove"},
    "prove.assemble": {"stark.prove"}, "lcomb.constraints": {"prove.lcomb"},
    "lcomb.boundary": {"prove.lcomb"}, "lcomb.tail": {"prove.lcomb"},
    "prover.keep": {"prove.commit", "prove.lcomb", "prove.fri", "prove.tail",
                    "lcomb.constraints", "lcomb.boundary", "lcomb.tail"},
}
WARM = set(PARENTS) - {"prover.new", "prover.keep"}
# the sites a new assertion structure's Prover adds to a warm prove's one fetch
FRESH_SITES = {"DftPlan.__init__.<locals>.<lambda>",
               "Prover._stage_commit.<locals>.<lambda>",
               "Prover._tail_static.<locals>.<lambda>"}
READERS = ("prover_build_ms", "prover_builds_per_proof", "constraints_ms", "serialize_ms",
           "syncs_per_proof", "idle_unspanned_pct")

_values = itertools.count(1000)
# last asserted steps that no earlier request asserted: each a new structure
_new_steps = itertools.count(62, -1)
# the request after a first one: "fresh" asserts a new step (a new
# structure), "values" new values at the same steps, "warm" the same statement
CASES = ("fresh", "values", "warm")


@pytest.fixture(scope="module")
def stark():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield instantiate_script(SOURCE, OPTIONS, device="cpu")
    torch.set_num_threads(threads)


def request(stark, v=None, last=63):
    """Prove and serialize the statement starting at v (fresh values by
    default) that asserts steps 0 and `last`; returns v."""
    v = next(_values) if v is None else v
    stark.serialize(stark.prove([Assertion(0, 0, v), Assertion(last, 0, v + 2 * last)], [[v]]))
    return v


def again(stark, case, v):
    """The request of `case` after a request that proved v."""
    if case == "fresh":
        return request(stark, last=next(_new_steps))
    return request(stark, None if case == "values" else v)


def traced(fn):
    """fn() under torch.profiler: (its spans, the profiler)."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return tracing.recorded(), prof


def by_request(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.request].append(s)
    return list(out.values())


@pytest.mark.parametrize("case", CASES)
def test_each_request_is_one_tree(stark, case):
    """Only a new structure builds a Prover (`prover.new`, `prover.keep`)."""
    v = request(stark)
    spans, _ = traced(lambda: again(stark, case, v))
    requests = by_request(spans)
    builds = {"prover.new", "prover.keep"} if case == "fresh" else set()
    assert [sorted({s.name for s in r}) for r in requests] == [
        sorted(WARM - {"stark.serialize"} | builds), ["stark.serialize"]]
    for r in requests:
        ids = {s.span: s for s in r}
        for s in r:
            parent = ids.get(s.parent)
            assert (parent.name if parent else None) in PARENTS[s.name], s.name
            assert s.start_ns <= s.end_ns
            if parent:
                assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns, s.name


def test_prove_spans_lie_on_the_profilers_ranges(stark):
    request(stark)
    spans, prof = traced(lambda: [request(stark) for _ in range(2)])
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("prove."):
            ranges[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    stages = [s for s in spans if s.name.startswith("prove.")]
    assert {s.name for s in stages} == {"prove.upload", "prove.commit", "prove.lcomb",
                                        "prove.fri", "prove.tail", "prove.assemble"}
    for name, theirs in ranges.items():
        mine = sorted((s.start_ns, s.end_ns) for s in stages if s.name == name)
        assert len(mine) == len(theirs) == 2
        for (a, b), (c, d) in zip(mine, sorted(theirs)):
            assert abs(a - c) < 200_000 and abs(b - d) < 200_000, name


def test_no_profiler_no_record_and_no_range(stark, monkeypatch):
    entered = []

    class Range:
        def __init__(self, name):
            entered.append(name)

    monkeypatch.setattr(tracing, "_Range", Range)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        lambda self: entered.append(self.name))
    tracing.clear()
    request(stark)
    assert tracing.recorded() == [] and entered == []
    assert stark.last_context.trace_seconds > 0


def test_a_prover_per_statement(stark):
    """A Prover per assertion structure: new values at the asserted steps
    reuse it, a new asserted step builds one."""
    request(stark)
    spans, _ = traced(lambda: [request(stark) for _ in range(2)])
    assert sum(s.name == "prover.new" for s in spans) == 0
    v = next(_values)
    spans, _ = traced(lambda: [request(stark, v) for _ in range(2)])
    assert sum(s.name == "prover.new" for s in spans) == 0
    spans, _ = traced(lambda: [request(stark, last=next(_new_steps)) for _ in range(2)])
    assert sum(s.name == "prover.new" for s in spans) == 2


def test_syncs_counted_at_their_sites(stark, monkeypatch):
    sites = []
    fetch, upload = tracing.fetch, tracing.upload

    def site():
        return sys._getframe(2).f_code.co_qualname

    monkeypatch.setattr(tracing, "fetch", lambda *a: (sites.append(site()), fetch(*a))[1])
    monkeypatch.setattr(tracing, "upload", lambda *a: (sites.append(site()), upload(*a))[1])

    def counted(fn):
        sites.clear()
        before = tracing.counters["syncs"]
        fn()
        return tracing.counters["syncs"] - before, collections.Counter(sites)

    v = request(stark)
    warm, warm_sites = counted(lambda: request(stark, v))
    assert warm == 1 and warm_sites == {"Prover.prove": 1}
    values, values_sites = counted(lambda: request(stark))
    assert values == 1 and values_sites == {"Prover.prove": 1}
    fresh, fresh_sites = counted(lambda: again(stark, "fresh", v))
    assert fresh == sum(fresh_sites.values()) > warm
    assert set(fresh_sites - warm_sites) == FRESH_SITES
    assert fresh_sites["Prover.prove"] == 1


def test_trace_seconds_is_the_air_trace_span(stark):
    spans, _ = traced(lambda: request(stark))
    (trace,) = [s for s in spans if s.name == "air.trace"]
    assert stark.last_context.trace_seconds == (trace.end_ns - trace.start_ns) / 1e9


# ----- the benchmark's readers

def S(name, start, end, span, parent, request, **deltas):
    return tracing.Span(name, start, end, span, parent, request, deltas)


# Two traced requests [0, 100] and [100, 200] (ns) and one outside the
# profile (request 9): a prove (a fresh Prover in the first) and a serialize
# each; the card works in [5, 10), [40, 50) and [150, 160).
TOY_SPANS = [
    S("stark.prove", 2, 80, 1, None, 1, syncs=12), S("prover.new", 5, 8, 2, 1, 1),
    S("prove.lcomb", 20, 60, 3, 1, 1), S("lcomb.constraints", 22, 40, 4, 3, 1),
    S("prover.keep", 25, 31, 5, 4, 1), S("prover.keep", 27, 29, 6, 5, 1),
    S("stark.serialize", 85, 95, 7, None, 2),
    S("stark.prove", 110, 170, 8, None, 3, syncs=1), S("prove.lcomb", 120, 140, 9, 8, 3),
    S("lcomb.constraints", 121, 125, 10, 9, 3), S("stark.serialize", 180, 186, 11, None, 4),
    S("stark.prove", 300, 390, 12, None, 9, syncs=50), S("prover.new", 301, 399, 13, 12, 9),
]
TOY_VALUES = {
    "prover_build_ms": (3 + 6) / 2 / 1e6,
    "prover_builds_per_proof": 0.5,
    "constraints_ms": (18 - 6 + 4) / 2 / 1e6,
    "serialize_ms": (10 + 6) / 2 / 1e6,
    "syncs_per_proof": 13 / 2,
    # neither the card nor a span other than stark.prove: [0, 5), [10, 20),
    # [60, 85), [95, 120), [140, 150), [160, 180), [186, 200)
    "idle_unspanned_pct": 100 * (5 + 10 + 25 + 25 + 10 + 20 + 14) / 200,
}


def toy_run():
    run = Run(seed=1, device="cpu")
    run.profile = Profile(requests=[(0, 100), (100, 200)], stages={},
                          device=[("k", 5, 10), ("k", 40, 50), ("k", 150, 160)])
    return run


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_toy_run(name, monkeypatch):
    monkeypatch.setattr(tracing, "recorded", lambda: list(TOY_SPANS))
    assert cells.metric_reader(name)(toy_run()) == pytest.approx(TOY_VALUES[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_without_the_programs_spans(name, monkeypatch):
    """A program without `tracing` (the parent of this change) reads None."""
    monkeypatch.setitem(sys.modules, "genstark_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["genstark_tpu_torch"], "tracing")
    assert cells.metric_reader(name)(toy_run()) is None


def test_readers_on_a_traced_cpu_run(stark):
    """Readers over real traced windows of two requests on the CPU, with
    new values at the asserted steps and then with new asserted steps (no
    device operations: idle_unspanned_pct reads None there)."""
    from torch.profiler import record_function
    request(stark)

    def window(case):
        before = tracing.counters["syncs"]
        tracing.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                with record_function("bench.request"):
                    again(stark, case, None)
        run = Run(seed=1, device="cpu")
        run.profile = Profile.from_profiler(prof)
        got = {name: cells.metric_reader(name)(run) for name in READERS}
        return got, (tracing.counters["syncs"] - before) / 2, run

    got, syncs, run = window("values")
    assert got["prover_builds_per_proof"] == 0.0 and got["prover_build_ms"] == 0.0
    assert got["syncs_per_proof"] == syncs == 1
    assert got["serialize_ms"] > 0
    assert 0 < got["constraints_ms"] < run.profile.stage_ms_per_request(("prove.lcomb",))
    assert got["idle_unspanned_pct"] is None
    got, syncs, run = window("fresh")
    assert got["prover_builds_per_proof"] == 1.0
    assert got["syncs_per_proof"] == syncs > 1
    assert got["prover_build_ms"] > 0 and got["serialize_ms"] > 0
    assert 0 < got["constraints_ms"] < run.profile.stage_ms_per_request(("prove.lcomb",))
    assert got["idle_unspanned_pct"] is None
