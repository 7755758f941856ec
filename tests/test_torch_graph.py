"""The one-fetch prover's recorded CUDA graph (protocol/prover.py
`_capture`): on the card a single-device Prover's first prove runs eager,
its second records the device work from the kept input buffers to the
packed tail as one CUDA graph, and every later prove replays it.

On the CPU (tier-1): the capture rule (a CPU Prover, the staged prover and,
in tests/test_torch_parallel.py, a ShardedProver never record or replay);
statements in a row on one Prover read through the kept input buffers to
their pins; and the prove's replay branch, with the graph stood in for by a
CPU double that reruns the recorded calls into the captured packed buffer
(as a graph rewrites its own buffers), gives the pins, the host fallback
(which runs the stages again) included.  Marked `cuda`, the same on the card with the real graph; they
skip where torch sees no card:

    python -m pytest tests/test_torch_graph.py --noconftest -o addopts="" -m cuda
"""

import hashlib
import itertools
import types

import pytest
import torch

from examples import poseidon_torch, rescue_torch
from examples.mimc_torch import make_mimc_stark, run_mimc
from genstark_tpu_torch import kernels, tracing
from genstark_tpu_torch.field import P128, P256
from genstark_tpu_torch.protocol import Assertion
from genstark_tpu_torch.protocol.prover import Prover
from genstark_tpu_torch.protocol.sharded import ShardedProver
from genstark_tpu_torch.testing import (BENCH_STEPS, MIMC128_INPUT_3_5_PINS, MIMC256_PIN,
                                        POSEIDON16_PIN, RESCUE16_PIN, TOY)


def _digest(data: bytes):
    return len(data), hashlib.sha256(data).hexdigest()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class Mimc:
    """MiMC over p128, 64 steps, 16 constants, the toy options, a secret
    input register: statement k runs from input k (MIMC128_INPUT_3_5_PINS
    are k = 3 and 5)."""

    def __init__(self, device):
        self.stark, self.constants = make_mimc_stark(64, device, modulus=P128, use_input=True,
                                                     constant_count=16, options=TOY)

    def prove(self, k, middle=False):
        """Statement k; `middle` asserts step 31 too: another structure,
        so another Prover of the Stark."""
        controls = run_mimc(self.stark.air.field, 64, self.constants, k)
        assertions = [Assertion(0, 0, controls[0]), Assertion(63, 0, controls[-1])]
        if middle:
            assertions.insert(1, Assertion(31, 0, controls[31]))
        return self.stark.serialize(self.stark.prove(assertions, [[k]]))

    @property
    def prover(self):
        (prover,) = self.stark._provers.values()
        return prover


def _replays():
    return tracing.counters["graph_replays"]


class CpuGraph:
    """A CPU stand-in for `torch.cuda.CUDAGraph`: `_capture` runs the calls
    it records once under `cpu_graph` (where the card would only record
    them), and `replay` reruns them from the kept input buffers into the
    captured packed buffer."""

    prover = None

    def replay(self):
        p = self.prover
        p._packed.copy_(p._packed_tail(*p._stages(*p._kept["inputs"])))


class cpu_graph:
    def __init__(self, graph, pool=None, capture_error_mode="global"):
        graph.pool, graph.capture_error_mode = pool, capture_error_mode

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def simulated(monkeypatch):
    """Provers on the CPU take the card's path: `_records_graph` answers
    as for a single-device Prover on a CUDA device, `_capture` runs with
    the CPU stand-in, and each pool handle is a fresh pair.  Yields the
    list of Provers that captured."""
    captured, handles = [], itertools.count()
    real = Prover._capture

    def capture(self, trace, inputs):
        captured.append(self)
        real(self, trace, inputs)
        self._graph.prover = self

    monkeypatch.setattr(Prover, "_records_graph", lambda self: True)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, next(handles)))
    monkeypatch.setattr(Prover, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", CpuGraph)
    monkeypatch.setattr(torch.cuda, "graph", cpu_graph)
    yield captured


@pytest.fixture
def never_captures(monkeypatch):
    def capture(self, trace, inputs):
        raise AssertionError(f"{type(self).__name__} on {self.dev.device} captured")

    monkeypatch.setattr(Prover, "_capture", capture)


# ------------------------------------------------------------ the CPU, tier-1
def test_the_rule_reads_the_device_and_the_class():
    """Only a single-device Prover on a CUDA device records a graph."""
    on = lambda cls, kind: cls._records_graph(types.SimpleNamespace(
        dev=types.SimpleNamespace(device=torch.device(kind))))
    assert on(Prover, "cuda") and not on(Prover, "cpu")
    assert not on(ShardedProver, "cuda") and not on(ShardedProver, "cpu")


def test_a_cpu_prover_never_captures(never_captures, monkeypatch):
    """Three statements on one CPU Prover run eager, each through the kept
    input buffers (the first prove's uploads), and give their pins."""
    case = Mimc("cpu")
    before, read = _replays(), []
    real = Prover._stages

    def stages(self, trace, inputs):
        read.append((trace.data_ptr(), inputs.data_ptr()))
        return real(self, trace, inputs)

    monkeypatch.setattr(Prover, "_stages", stages)
    got = [_digest(case.prove(k)) for k in (7, 3, 5)]
    assert got[1:] == MIMC128_INPUT_3_5_PINS
    kept = case.prover._kept["inputs"]
    assert read == [(kept[0].data_ptr(), kept[1].data_ptr())] * 3
    assert case.prover._graph is None and _replays() == before


def test_the_staged_prover_never_captures(never_captures):
    case = Mimc("cpu")
    before = _replays()
    controls = run_mimc(case.stark.air.field, 64, case.constants, 3)
    assertions = [Assertion(0, 0, controls[0]), Assertion(63, 0, controls[-1])]
    got = [_digest(case.stark.serialize(case.stark.prove_staged(assertions, [[3]])))
           for _ in range(2)]
    assert got == [MIMC128_INPUT_3_5_PINS[0]] * 2
    assert case.stark._provers == {} and _replays() == before


def test_the_second_prove_captures_and_later_ones_replay(simulated):
    """On the card's path: the first prove eager, the second captures and
    replays, the third replays; each statement gives its pin (a replay that
    read the previous statement's inputs would not)."""
    case = Mimc("cpu")
    before = _replays()
    case.prove(7)
    assert simulated == [] and _replays() == before
    assert _digest(case.prove(3)) == MIMC128_INPUT_3_5_PINS[0]
    assert simulated == [case.prover] and _replays() == before + 1
    assert _digest(case.prove(5)) == MIMC128_INPUT_3_5_PINS[1]
    assert simulated == [case.prover] and _replays() == before + 2
    assert case.prover.host_fallbacks == 0


def test_a_replayed_prove_falls_back_with_the_same_bytes(simulated, monkeypatch):
    """The host-sampled path gathers from the replay's outputs."""
    case = Mimc("cpu")
    case.prove(7)
    case.prove(3)
    monkeypatch.setattr(Prover, "_assemble_device_sampled", lambda self, packed: None)
    assert _digest(case.prove(5)) == MIMC128_INPUT_3_5_PINS[1]
    assert case.prover.host_fallbacks == 1


def _two_structures(device):
    """Statements 7, 3 and 5 of two structures in turn on one Stark (eager,
    recorded, replayed on each Prover) -> (the Stark, {(k, middle): digest})."""
    case = Mimc(device)
    got = {}
    for k in (7, 3, 5):
        for middle in (False, True):
            got[k, middle] = _digest(case.prove(k, middle))
    return case.stark, got


def _check_two_structures(stark, got, captured):
    """Both Provers recorded into the Stark's one pool, thread-local, and
    every statement gave the bytes of an eager prove on a fresh CPU Stark."""
    provers = list(stark._provers.values())
    assert captured == provers and len(provers) == 2
    assert [p._graph.pool for p in provers] == [stark.graph_pool()] * 2
    assert [p._graph.capture_error_mode for p in provers] == ["thread_local"] * 2
    assert [got[3, False], got[5, False]] == MIMC128_INPUT_3_5_PINS
    for k in (7, 3, 5):
        assert got[k, True] == _digest(Mimc("cpu").prove(k, middle=True))
    assert all(p.host_fallbacks == 0 for p in provers)


def test_two_structures_share_the_stark_s_pool(simulated):
    stark, got = _two_structures("cpu")
    _check_two_structures(stark, got, simulated)


def test_graph_pool_bytes_reads_the_pool_s_segments(monkeypatch):
    """The Stark makes its pool once; its bytes are the snapshot's segments
    of that pool, None before a Prover asked for it."""
    case = Mimc("cpu")
    assert case.stark.graph_pool_bytes() is None
    handles = iter([(0, 4), (0, 5)])
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: next(handles))
    assert case.stark.graph_pool() == case.stark.graph_pool() == (0, 4)
    segments = [{"segment_pool_id": (0, 4), "total_size": 2 << 20},
                {"segment_pool_id": (0, 0), "total_size": 1 << 30},
                {"segment_pool_id": (0, 4), "total_size": 6 << 20}]
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: segments)
    assert case.stark.graph_pool_bytes() == 8 << 20


# --------------------- the benchmark's graph_replays_per_proof and graph_pool_gib
def _reader():
    from benchmark import cells
    return cells.metric_reader("graph_replays_per_proof")


def _toy_run():
    from benchmark.run import Run
    from benchmark.trace import Profile
    run = Run(seed=1, device="cpu")
    run.profile = Profile(requests=[(0, 100), (100, 200)], stages={}, device=[])
    return run


S = lambda name, start, end, span, parent, request, **deltas: tracing.Span(
    name, start, end, span, parent, request, deltas)
# two traced requests, [0, 100] and [100, 200] ns (the first eager, the
# second replayed), and a replayed one outside the profile (request 9)
TOY_SPANS = [
    S("stark.prove", 2, 80, 1, None, 1),
    S("stark.serialize", 85, 95, 2, None, 2),
    S("stark.prove", 110, 170, 3, None, 3, graph_replays=1),
    S("prove.replay", 120, 130, 4, 3, 3, graph_replays=1),
    S("stark.prove", 300, 390, 5, None, 9, graph_replays=1),
]


def test_reader_on_a_toy_run(monkeypatch):
    monkeypatch.setattr(tracing, "recorded", lambda: list(TOY_SPANS))
    assert _reader()(_toy_run()) == 0.5


def test_reader_without_the_counter(monkeypatch):
    """A program whose counters have no `graph_replays` (the parent of this
    change) reads None."""
    monkeypatch.setattr(tracing, "recorded", lambda: [s._replace(deltas={}) for s in TOY_SPANS])
    monkeypatch.setattr(tracing, "counters", {"syncs": 0, "trace_products": 0,
                                              "upload_bytes": 0})
    assert _reader()(_toy_run()) is None


@pytest.mark.parametrize("path", ["eager", "replayed"])
def test_reader_on_a_traced_cpu_run(request, path):
    """Two traced requests after two warm-up proves: 0 a request on the
    CPU's eager path, 1 on the card's path (the CPU stand-in's replays)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from benchmark.run import Run
    from benchmark.trace import Profile
    if path == "replayed":
        request.getfixturevalue("simulated")
    case = Mimc("cpu")
    for k in (7, 3):
        case.prove(k)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in (4, 5):
            with record_function("bench.request"):
                case.prove(k)
    run = Run(seed=1, device="cpu")
    run.profile = Profile.from_profiler(prof)
    assert _reader()(run) == (1.0 if path == "replayed" else 0.0)


def _pool_run(stark):
    run = _toy_run()
    run.stark = stark
    return run


@pytest.mark.parametrize("held, gib", [(3 << 29, 1.5), (0, 0.0), (None, None)])
def test_pool_reader(held, gib):
    from benchmark import cells
    read = cells.metric_reader("graph_pool_gib")
    assert read(_pool_run(types.SimpleNamespace(graph_pool_bytes=lambda: held))) == gib


def test_pool_reader_on_a_program_without_the_pool():
    """A Stark without `graph_pool_bytes` (the parent of this change), and
    a CPU Stark, whose Provers record no graph, read None."""
    from benchmark import cells
    read = cells.metric_reader("graph_pool_gib")
    assert read(_pool_run(types.SimpleNamespace())) is None
    case = Mimc("cpu")
    case.prove(3)
    assert read(_pool_run(case.stark)) is None


# ------------------------------------------------------------------ the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_replays_give_the_pins(card):
    """A warm-up statement (eager), then statements 3 (captured) and 5
    (replayed) on one Stark."""
    case = Mimc(card)
    before = _replays()
    case.prove(7)
    got = [_digest(case.prove(k)) for k in (3, 5)]
    assert got == MIMC128_INPUT_3_5_PINS
    assert case.prover._graph is not None and _replays() == before + 2
    assert case.prover.host_fallbacks == 0


def _mimc256(device):
    """MIMC256_PIN's statement: MiMC-256, 2^13 steps, the bench options,
    secret input 3 (examples/mimc_torch.py `prove_mimc`)."""
    stark, constants = make_mimc_stark(BENCH_STEPS, device, modulus=P256)
    controls = run_mimc(stark.air.field, BENCH_STEPS, constants, 3)
    assertions = [Assertion(0, 0, controls[0]), Assertion(BENCH_STEPS - 1, 0, controls[-1])]
    return stark, assertions, [[3]]


CASES = {"poseidon16": (lambda device: poseidon_torch.branch_case(16, 42, None, device)[:3],
                        POSEIDON16_PIN),
         "rescue16": (lambda device: rescue_torch.branch_case(16, 42, None, device)[:3],
                      RESCUE16_PIN),
         "mimc256": (_mimc256, MIMC256_PIN)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_card_third_prove_gives_the_pin(card, name):
    """The pinned statement three times on one Stark: eager, captured,
    replayed."""
    make, pin = CASES[name]
    stark, assertions, inputs = make(card)
    before = _replays()
    got = [_digest(stark.serialize(stark.prove(assertions, inputs))) for _ in range(3)]
    assert got == [pin] * 3
    (prover,) = stark._provers.values()
    assert _replays() == before + 2 and prover.host_fallbacks == 0


@pytest.mark.cuda
def test_card_replayed_fallback_gives_the_same_bytes(card, monkeypatch):
    case = Mimc(card)
    case.prove(7)
    case.prove(3)
    monkeypatch.setattr(Prover, "_assemble_device_sampled", lambda self, packed: None)
    assert _digest(case.prove(5)) == MIMC128_INPUT_3_5_PINS[1]
    assert case.prover.host_fallbacks == 1


@pytest.mark.cuda
def test_card_replay_launches_nothing_and_fetches_once(card):
    """A replayed prove: one replay, one sync (the fetch), no launch
    through a wrapper, and none of the commit, lcomb and FRI spans."""
    from torch.profiler import ProfilerActivity, profile
    case = Mimc(card)
    case.prove(7)
    case.prove(3)
    counters, launches = dict(tracing.counters), dict(kernels.launch_counts)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        assert _digest(case.prove(5)) == MIMC128_INPUT_3_5_PINS[1]
    grew = {k: tracing.counters[k] - counters[k] for k in counters}
    assert grew["graph_replays"] == 1 and grew["syncs"] == 1
    assert kernels.launch_counts == launches
    names = {s.name for s in tracing.recorded()}
    assert "prove.replay" in names and "prove.tail" in names
    assert not names & {"prove.commit", "prove.lcomb", "prove.fri", "lcomb.constraints"}


@pytest.mark.cuda
def test_card_failed_capture_raises(card, monkeypatch):
    """An upload inside the recorded stages raises at the capture, and the
    next prove tries again rather than running eager."""
    case = Mimc(card)
    case.prove(7)
    monkeypatch.setattr(Prover, "_inv_series", lambda self: self.dev.from_ints(
        self.c_poly.z_poly.inverse_numerators()))
    for k in (3, 5):
        with pytest.raises(RuntimeError):
            case.prove(k)
        assert case.prover._graph is None


@pytest.mark.cuda
def test_card_two_structures_share_the_stark_s_pool(card, monkeypatch):
    """Two Provers of one Stark record into its one pool and replay in turn:
    each replay rewrites memory the other's graph also uses, and each
    statement still gives an eager prove's bytes."""
    captured, real, recording = [], Prover._capture, torch.cuda.graph

    class graph(recording):
        def __init__(self, cuda_graph, pool=None, capture_error_mode="global", **kw):
            super().__init__(cuda_graph, pool=pool, capture_error_mode=capture_error_mode, **kw)
            cuda_graph.pool, cuda_graph.capture_error_mode = pool, capture_error_mode

    def capture(self, trace, inputs):
        captured.append(self)
        real(self, trace, inputs)

    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(Prover, "_capture", capture)
    stark, got = _two_structures(card)
    _check_two_structures(stark, got, captured)
    assert stark.graph_pool_bytes() > 0
