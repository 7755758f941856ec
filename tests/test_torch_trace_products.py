"""The native trace's product counter, `tracing.counters["trace_products"]`
(counted per schema at codegen by genstark_tpu_torch/native/tracegen.py and
added by air/module.py inside the `air.trace` span), against counts made
here by hand from the field and the exponents; and the benchmark's two
readers of it (benchmark/metrics/trace_products_per_proof.py,
trace_ns_per_product.py)."""

import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import cells
from benchmark.run import Run
from benchmark.trace import Profile
from examples.mimc_torch import make_mimc_stark, run_mimc
from examples.rescue_torch import P128_INV_ALPHA, branch_case
from genstark_tpu_torch import tracing
from genstark_tpu_torch.field import P128
from genstark_tpu_torch.native import tracegen
from genstark_tpu_torch.protocol import Assertion

READERS = ("trace_products_per_proof", "trace_ns_per_product")
TOY_OPTIONS = {"extension_factor": 4, "exe_query_count": 8, "fri_query_count": 6}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def counted(ctx) -> int:
    """The counter's growth over one trace of the context."""
    before = tracing.counters["trace_products"]
    ctx.generate_execution_trace_std()
    return tracing.counters["trace_products"] - before


def rescue_context(depth: int):
    stark, _, inputs, _ = branch_case(depth, index=5, device="cpu")
    return stark.air.init_proving_context(inputs)


def test_mimc_counts_its_cube_a_step():
    """x^3 + k: one squaring and one product a step; init yields the input."""
    stark, _ = make_mimc_stark(64, "cpu", options=TOY_OPTIONS)
    ctx = stark.air.init_proving_context([[3]])
    assert counted(ctx) == 2 * 63
    assert ctx.trace_source == "native"


def test_rescue_counts_the_same_each_step():
    """Depth 2 and depth 4: the same products a step, and totals that are
    whole multiples of the steps (init loads and multiplies nothing)."""
    per_step = set()
    for depth in (2, 4):
        ctx = rescue_context(depth)
        steps = ctx.trace_length - 1
        assert ctx.trace_length == 32 * depth
        total = counted(ctx)
        assert total % steps == 0
        per_step.add(total // steps)
    assert len(per_step) == 1


def test_rescue_counts_its_inversions_and_roots():
    """Each of the eight elements a step takes an inversion (a Fermat ladder
    over p - 2 of 128 bits) and the 127-bit inverse power: at least that
    many products a step, computed from the field and the exponent."""
    fermat = 128 + bin(P128 - 2).count("1")
    e = -P128_INV_ALPHA
    root = (e.bit_length() - 1) + (bin(e).count("1") - 1)
    assert (fermat, e.bit_length()) == (254, 127)
    ctx = rescue_context(2)
    assert counted(ctx) // (ctx.trace_length - 1) >= 8 * (fermat + root)


def test_ladder_products_of_the_fields():
    assert tracegen.ladder_products(P128) == 254
    assert tracegen.ladder_products(2 ** 64 - 2 ** 32 + 1) == 64 + 63


def test_python_fallback_adds_nothing(monkeypatch):
    stark, _ = make_mimc_stark(64, "cpu", options=TOY_OPTIONS)
    ctx = stark.air.init_proving_context([[3]])
    monkeypatch.setattr(tracegen, "CXX", "no-such-compiler-on-this-host")
    monkeypatch.setattr(tracegen, "_compile", tracegen._compile.__wrapped__)
    assert counted(ctx) == 0
    assert ctx.trace_source == "python"


def test_air_trace_span_carries_the_counter():
    stark, _ = make_mimc_stark(64, "cpu", options=TOY_OPTIONS)
    ctx = stark.air.init_proving_context([[3]])
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        total = counted(ctx)
    (span,) = [s for s in tracing.recorded() if s.name == "air.trace"]
    assert span.deltas["trace_products"] == total == 126


# ----- the benchmark's readers

def S(name, start, end, span, parent, request, **deltas):
    return tracing.Span(name, start, end, span, parent, request, deltas)


# Two traced requests [0, 100] and [100, 200] (ns) and one outside the
# profile (request 9): a prove, its trace and a serialize each.
TOY_SPANS = [
    S("stark.prove", 2, 80, 1, None, 1, trace_products=600),
    S("air.trace", 5, 35, 2, 1, 1, trace_products=600),
    S("stark.serialize", 85, 95, 3, None, 2),
    S("stark.prove", 110, 170, 4, None, 3, trace_products=600),
    S("air.trace", 111, 141, 5, 4, 3, trace_products=600),
    S("stark.prove", 300, 390, 6, None, 9, trace_products=9000),
    S("air.trace", 301, 399, 7, 6, 9, trace_products=9000),
]
TOY_VALUES = {"trace_products_per_proof": 600, "trace_ns_per_product": 60 / 1200}


def toy_run():
    run = Run(seed=1, device="cpu")
    run.profile = Profile(requests=[(0, 100), (100, 200)], stages={}, device=[])
    return run


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_toy_run(name, monkeypatch):
    monkeypatch.setattr(tracing, "recorded", lambda: list(TOY_SPANS))
    assert cells.metric_reader(name)(toy_run()) == pytest.approx(TOY_VALUES[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_without_the_counter(name, monkeypatch):
    """A program whose spans carry no such counter reads None."""
    bare = [s._replace(deltas={}) for s in TOY_SPANS]
    monkeypatch.setattr(tracing, "recorded", lambda: bare)
    monkeypatch.setattr(tracing, "counters", {"syncs": 0})
    assert cells.metric_reader(name)(toy_run()) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_without_the_programs_spans(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "genstark_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["genstark_tpu_torch"], "tracing")
    assert cells.metric_reader(name)(toy_run()) is None


def test_readers_on_a_traced_cpu_run():
    """Two traced MiMC requests of 64 steps on the CPU: 126 products each."""
    stark, constants = make_mimc_stark(64, "cpu", options=TOY_OPTIONS)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for v in (3, 4):
            controls = run_mimc(stark.air.field, 64, constants, v)
            with record_function("bench.request"):
                stark.serialize(stark.prove(
                    [Assertion(0, 0, controls[0]), Assertion(63, 0, controls[-1])], [[v]]))
    run = Run(seed=1, device="cpu")
    run.profile = Profile.from_profiler(prof)
    assert cells.metric_reader("trace_products_per_proof")(run) == 126
    assert cells.metric_reader("trace_ns_per_product")(run) > 0
