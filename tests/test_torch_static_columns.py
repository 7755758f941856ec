"""The one-fetch prover's static registers (protocol/prover.py): the input
registers' columns expanded on the device from their values, the cyclic
registers' composition-domain evaluations kept by the Prover, and no
T-length static column built or uploaded by a warm prove.  Three schemas
with both kinds of static register, at toy sizes on the CPU: MiMC over
p128 with a secret input (one cyclic and one input register), the Poseidon
Merkle-branch script (ten cyclic, five input registers, the index bits
public) and the Rescue Merkle-branch script (eleven cyclic, three input
registers, the siblings a nested input).  Exact comparisons against
`ProvingContext.statics_std`, the full-column path, and against the JAX
package's bytes of two statements proved in a row on one of its Starks
(pinned here; the `slow` test recomputes the pins)."""

import hashlib

import numpy as np
import pytest
import torch

from examples import poseidon_torch, rescue_torch
from examples.mimc_torch import make_mimc_stark, run_mimc
from genstark_tpu_torch import tracing
from genstark_tpu_torch.field import P128
from genstark_tpu_torch.field.device import DeviceField
from genstark_tpu_torch.protocol import Assertion
from genstark_tpu_torch.protocol.prover import Prover, _to_mont_batch
from genstark_tpu_torch.testing import MIMC128_INPUT_3_5_PINS

TOY = {"extension_factor": 4, "exe_query_count": 8, "fri_query_count": 6}
TOY_16 = {"hash_algorithm": "blake2s256", "extension_factor": 16,
          "exe_query_count": 8, "fri_query_count": 6}
TOY_32 = dict(TOY_16, extension_factor=32)


class Mimc:
    """64 steps over p128, a secret input register; statement k is the run
    from input k, its first and last values asserted."""

    keys = (3, 5)

    def make(self):
        stark, self.constants = make_mimc_stark(64, "cpu", modulus=P128, use_input=True,
                                                constant_count=16, options=TOY)
        return stark

    def statement(self, stark, k):
        controls = run_mimc(stark.air.field, 64, self.constants, k)
        return [Assertion(0, 0, controls[0]), Assertion(63, 0, controls[-1])], [[k]], []

    def jax(self):
        from examples.mimc import make_mimc_stark as jax_make_mimc_stark
        from examples.mimc import run_mimc as jax_run_mimc
        from genstark_tpu.protocol import Assertion as JaxAssertion
        stark, constants = jax_make_mimc_stark(64, modulus=P128, use_input=True,
                                               constant_count=16, options=TOY)
        out = []
        for k in self.keys:
            controls = jax_run_mimc(stark.air.field, 64, constants, k)
            out.append(stark.serialize(stark.prove(
                [JaxAssertion(0, 0, controls[0]), JaxAssertion(63, 0, controls[-1])], [[k]])))
        return out


class Branch:
    """A Merkle branch of depth 2 (examples' `branch_case`): statement k
    proves membership at index k (below 2^(depth - 1): the last index bit
    is not an input), so the two statements differ in their public index
    bits and their asserted root."""

    keys = (0, 1)

    def __init__(self, module, options, jax_source):
        self.module, self.options, self.jax_source = module, options, jax_source

    def make(self):
        return self.module.make_merkle_stark(dict(self.options), "cpu")[0]

    def statement(self, stark, k):
        return self.module.branch_case(2, k, dict(self.options), "cpu")[1:]

    def jax(self):
        from genstark_tpu import instantiate_script as jax_instantiate_script
        from genstark_tpu.protocol import Assertion as JaxAssertion
        stark = jax_instantiate_script(self.jax_source(), dict(self.options))
        out = []
        for k in self.keys:
            assertions, inputs, _ = self.statement(None, k)
            out.append(stark.serialize(stark.prove(
                [JaxAssertion(a.step, a.register, a.value) for a in assertions], inputs)))
        return out


def _rescue_source():
    from examples.rescue_utils import invert_matrix
    field, rescue, _, _, rc = rescue_torch.make_rescue(4)
    return rescue_torch.merkle_source(rescue.alpha, -rescue.inv_alpha, rescue.mds,
                                      invert_matrix(field.host, rescue.mds), rc)


CASES = {
    "mimc": Mimc(),
    "poseidon": Branch(poseidon_torch, TOY_32,
                       lambda: poseidon_torch.merkle_source(*poseidon_torch.poseidon_params(6)[1:])),
    "rescue": Branch(rescue_torch, TOY_16, _rescue_source),
}
# (length, sha256) of the JAX package's proofs of the two statements, in a
# row on one Stark (`test_pins_are_the_jax_packages` recomputes them)
JAX_PINS = {
    "mimc": MIMC128_INPUT_3_5_PINS,
    "poseidon": [(18826, "f250bec8de36e259af155abb803764da48705bc196b011091c9191e5e7c17415"),
                 (18729, "205088492469efd519c27cc14473a7c69b3948b189f434cdc600e4e904c4f97f")],
    "rescue": [(12970, "b3a9e672bab5c8bda966bc7067a56097aee438e4b22c8f5cd4856dfe6c9a49c7"),
               (13097, "97ded746e5a4bb0a1721e48cea85041b9562245e877de1dde3f42d8c733ab641")],
}


def _digest(data: bytes):
    return len(data), hashlib.sha256(data).hexdigest()


@pytest.fixture(scope="module", params=list(CASES))
def proved(request):
    """One Stark proves the case's two statements in a row, the second
    with every `DeviceField.from_numpy` shape, the commit stage's input
    polynomials and the counters' growth recorded; a fresh Stark proves
    the second alone."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    shapes, input_polys = [], []
    from_numpy, stage_lcomb = DeviceField.from_numpy, Prover._stage_lcomb

    def recorded(self, arr):
        shapes.append(np.shape(arr))
        return from_numpy(self, arr)

    def lcomb(self, p_polys, polys, *args):
        input_polys.append(polys)
        return stage_lcomb(self, p_polys, polys, *args)

    try:
        case = CASES[request.param]
        stark = case.make()
        statements = [case.statement(stark, k) for k in case.keys]
        first = stark.serialize(stark.prove(*statements[0][:2]))
        before = dict(tracing.counters)
        DeviceField.from_numpy, Prover._stage_lcomb = recorded, lcomb
        proof = stark.prove(*statements[1][:2])
        DeviceField.from_numpy, Prover._stage_lcomb = from_numpy, stage_lcomb
        grew = {k: tracing.counters[k] - before[k] for k in before}
        second = stark.serialize(proof)
        fresh = case.make()
        fresh_bytes = fresh.serialize(fresh.prove(*statements[1][:2]))
        (prover,) = stark._provers.values()
        return dict(name=request.param, stark=stark, prover=prover, statements=statements,
                    context=stark.last_context, bytes=[first, second], fresh=fresh_bytes,
                    shapes=shapes, input_polys=input_polys[0], grew=grew)
    finally:
        DeviceField.from_numpy, Prover._stage_lcomb = from_numpy, stage_lcomb
        torch.set_num_threads(saved)


def test_both_kinds_of_static_register(proved):
    prover = proved["prover"]
    assert prover.cyclic_regs and prover.input_regs
    assert sorted(prover.cyclic_regs + prover.input_regs) == \
        list(range(len(proved["context"].schema.static_registers)))


def test_expanded_inputs_are_the_static_columns(proved):
    """`input_values_std` gathered through `input_gather_index` is the
    input registers' rows of `statics_std`, limb for limb."""
    ctx, prover = proved["context"], proved["prover"]
    L, T = prover.dev.L, ctx.trace_length
    index = ctx.input_gather_index("cpu")
    values = torch.from_numpy(ctx.input_values_std().astype(np.int32))
    columns = values.index_select(1, index).view(L, len(prover.input_regs), T)
    want = ctx.statics_std()[prover.input_regs].astype(np.int32)
    assert torch.equal(columns.permute(1, 0, 2), torch.from_numpy(want))


def test_static_evaluations_equal_the_full_columns(proved):
    """The kept cyclic evaluations and the input registers' evaluations of
    the commit stage are the Montgomery evaluations over the composition
    domain that `statics_std`'s columns give, register by register."""
    ctx, prover = proved["context"], proved["prover"]
    dev = prover.dev
    Nc = ctx.composition_domain_size
    full = prover._lde(prover._transform(
        _to_mont_batch(dev, dev.from_numpy(ctx.statics_std())), "w_T_inv"), Nc, "w_Nc")
    inputs = prover._lde(proved["input_polys"], Nc, "w_Nc")
    cyclic = prover._cyclic_evals()
    assert cyclic is prover._kept["cyclic_evals"]
    for j, k in enumerate(prover.input_regs):
        assert torch.equal(inputs[j], full[k]), k
    for j, k in enumerate(prover.cyclic_regs):
        assert torch.equal(cyclic[j], full[k]), k


def test_consecutive_statements_give_the_jax_bytes(proved):
    """Both statements, in a row on one Stark, are the JAX package's bytes,
    and a fresh Stark proves the second's."""
    assert [_digest(b) for b in proved["bytes"]] == JAX_PINS[proved["name"]]
    assert proved["fresh"] == proved["bytes"][1] != proved["bytes"][0]


def test_each_proof_verifies_against_its_own_statement(proved):
    stark = proved["stark"]
    (a, _, a_public), (b, _, b_public) = proved["statements"]
    assert stark.verify(a, stark.parse(proved["bytes"][0]), a_public)
    assert stark.verify(b, stark.parse(proved["bytes"][1]), b_public)


def test_a_warm_prove_uploads_the_trace_and_the_input_values(proved):
    """The warm prove's host-to-device copies: the trace [R, L, T], the
    input registers' values [L, sum of n_k], and the limbs of single
    constants ([L]: the plain DFT's, on the CPU); no other T-length upload
    and no static column.  `upload_bytes` grows by exactly their bytes,
    and the one fetch is the prove's only sync."""
    ctx, prover = proved["context"], proved["prover"]
    L, T, R = prover.dev.L, ctx.trace_length, ctx.schema.trace_width
    n = sum(len(ctx.input_values[k]) for k in prover.input_regs)
    shapes = proved["shapes"]
    assert [s for s in shapes if s[-1] == T] == [(R, L, T)]
    assert shapes.count((L, n)) == 1
    small = [s for s in shapes if s not in ((R, L, T), (L, n))]
    assert all(s == (L,) for s in small)
    assert proved["grew"]["upload_bytes"] == 4 * L * (R * T + n) + 4 * L * len(small)
    assert proved["grew"]["syncs"] == 1


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CASES))
def test_pins_are_the_jax_packages(name):
    """Recomputes JAX_PINS (the Merkle scripts: minutes of XLA:CPU)."""
    assert [_digest(b) for b in CASES[name].jax()] == JAX_PINS[name]


# ----- the benchmark's reader of the counter (benchmark/metrics/)

def S(name, start, end, span, parent, request, **deltas):
    return tracing.Span(name, start, end, span, parent, request, deltas)


# Two traced requests [0, 100] and [100, 200] (ns) and one outside the
# profile (request 9): a prove (a fresh Prover's keeps in the first) and a
# serialize each.
TOY_SPANS = [
    S("stark.prove", 2, 80, 1, None, 1, upload_bytes=5000),
    S("prover.keep", 5, 8, 2, 1, 1, upload_bytes=1000),
    S("stark.serialize", 85, 95, 3, None, 2),
    S("stark.prove", 110, 170, 4, None, 3, upload_bytes=3000),
    S("prove.upload", 111, 121, 5, 4, 3, upload_bytes=3000),
    S("stark.prove", 300, 390, 6, None, 9, upload_bytes=90000),
]


def toy_run():
    from benchmark.run import Run
    from benchmark.trace import Profile
    run = Run(seed=1, device="cpu")
    run.profile = Profile(requests=[(0, 100), (100, 200)], stages={}, device=[])
    return run


def reader():
    from benchmark import cells
    return cells.metric_reader("upload_bytes_per_proof")


def test_reader_on_a_toy_run(monkeypatch):
    monkeypatch.setattr(tracing, "recorded", lambda: list(TOY_SPANS))
    assert reader()(toy_run()) == (5000 + 3000) / 2


def test_reader_without_the_counter(monkeypatch):
    """A program whose counters have no `upload_bytes` (the parent of this
    change) reads None."""
    monkeypatch.setattr(tracing, "recorded", lambda: [s._replace(deltas={}) for s in TOY_SPANS])
    monkeypatch.setattr(tracing, "counters", {"syncs": 0, "trace_products": 0})
    assert reader()(toy_run()) is None


def test_reader_without_the_programs_spans(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "genstark_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["genstark_tpu_torch"], "tracing")
    assert reader()(toy_run()) is None


def test_reader_on_a_traced_cpu_run():
    """Two traced warm MiMC requests on the CPU: the reader reads the
    counter's growth a request, the trace and the input value and the
    plain DFT's constants, and no static column."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from benchmark.run import Run
    from benchmark.trace import Profile
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        case = Mimc()
        stark = case.make()
        stark.prove(*case.statement(stark, 3)[:2])
        ctx = stark.last_context
        L, T = stark.dev.L, ctx.trace_length
        before = tracing.counters["upload_bytes"]
        tracing.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for k in (4, 5):
                with record_function("bench.request"):
                    stark.serialize(stark.prove(*case.statement(stark, k)[:2]))
    finally:
        torch.set_num_threads(saved)
    run = Run(seed=1, device="cpu")
    run.profile = Profile.from_profiler(prof)
    got = reader()(run)
    assert got == (tracing.counters["upload_bytes"] - before) / 2
    assert 4 * L * (T + 1) <= got < 4 * L * (2 * T)
