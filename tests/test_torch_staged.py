"""The port's staged prover and its stage-level API against the JAX
package, exactly (tolerance 0): the public `ntt` / `intt` /
`low_degree_extend`, the device `MerkleTree`, `CompositionPolynomial.
evaluate_all`, `LinearCombination.compute_many` and `LowDegreeProver.prove`
on the same inputs; `prove_staged` as a whole (bytes equal to the JAX
`prove_staged`'s and to the port's `prove`, the pins, the JAX verifier, the
log messages, the error types).

The JAX side is held to one configuration (tests/test_fused_vs_staged.py's:
P32, 64 steps, ext 8, 10/6 queries) and built once a module, so its XLA
compiles stay few."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.mimc_torch import prove_mimc, run_mimc
from genstark_tpu import instantiate as jax_instantiate
from genstark_tpu import ntt as jax_ntt
from genstark_tpu.air import AirSchema as JaxSchema
from genstark_tpu.air.ir import CyclicRegister as JaxCyclic
from genstark_tpu.air.ir import const, nxt, static, trace
from genstark_tpu.field import create_prime_field as jax_field
from genstark_tpu.hash import create_hash as jax_hash
from genstark_tpu.merkle import MerkleTree as JaxTree
from genstark_tpu.protocol import Assertion as JaxAssertion
from genstark_tpu.protocol.composition import CompositionPolynomial as JaxComposition
from genstark_tpu.protocol.fri import LowDegreeProver as JaxLowDegreeProver
from genstark_tpu.protocol.lincomb import LinearCombination as JaxLinearCombination
from genstark_tpu.utils import Logger as JaxLogger
from genstark_tpu_torch import instantiate, ntt
from genstark_tpu_torch.air.convert import schema_from_reference
from genstark_tpu_torch.field import P32, P128, create_prime_field
from genstark_tpu_torch.hash import create_hash
from genstark_tpu_torch.merkle import MerkleTree
from genstark_tpu_torch.protocol import Assertion, StarkError
from genstark_tpu_torch.protocol.composition import CompositionPolynomial
from genstark_tpu_torch.protocol.fri import LowDegreeProver
from genstark_tpu_torch.protocol.lincomb import LinearCombination
from genstark_tpu_torch.utils import Logger

OPTIONS = {"extension_factor": 8, "exe_query_count": 10, "fri_query_count": 6}
TOY = {"extension_factor": 4, "exe_query_count": 8, "fri_query_count": 6}
SEED = bytes(range(32))


@pytest.fixture(autouse=True)
def _one_thread():
    # the plain versions' many small ops: faster on one thread while the
    # other test workers hold the cores
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _elements(rng, modulus, shape):
    ints = [int(v) % modulus for v in rng.integers(0, 1 << 62, size=int(np.prod(shape)))]
    return ints


def _to_jax(t: torch.Tensor):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _equal(got: torch.Tensor, want) -> bool:
    return np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))


# ----- the public NTT ---------------------------------------------------------
@pytest.mark.parametrize("modulus", [P32, P128], ids=["p32", "p128"])
@pytest.mark.parametrize("n", [64, 256])
def test_ntt_intt_lde_match_jax(modulus, n):
    field, jfield = create_prime_field(modulus), jax_field(modulus)
    dev = field.device_field("cpu")
    rng = np.random.default_rng(n + modulus % 97)
    x = dev.from_ints(_elements(rng, modulus, (n,)))                   # [L, n] Montgomery
    jx = _to_jax(x)
    fwd, inv = ntt.ntt(field, x), ntt.intt(field, x)
    assert _equal(fwd, jax_ntt.ntt(jfield, jx))
    assert _equal(inv, jax_ntt.intt(jfield, jx))
    assert torch.equal(ntt.intt(field, fwd), x)
    if n == 64:
        lde = ntt.low_degree_extend(field, inv, 256)
        assert _equal(lde, jax_ntt.low_degree_extend(jfield, jnp.asarray(
            inv.numpy().astype(np.uint32)), 256))
        assert torch.equal(lde[:, ::4], x)
        # a batch [B, L, n] is each row's transform
        xb = torch.stack([x, fwd])
        assert torch.equal(ntt.ntt(field, xb), torch.stack([fwd, ntt.ntt(field, fwd)]))


def test_ntt_plans_are_cached(monkeypatch):
    """A repeated call builds no plan (and so uploads no table)."""
    field = create_prime_field(P32)
    x = field.device_field("cpu").from_ints(list(range(32)))
    ntt.intt(field, ntt.ntt(field, x))
    made = []
    real = ntt.make_plan
    monkeypatch.setattr(ntt, "make_plan", lambda *a, **k: made.append(a) or real(*a, **k))
    ntt.intt(field, ntt.ntt(field, x))
    assert made == []


# ----- the device Merkle tree -------------------------------------------------
@pytest.mark.parametrize("algorithm", ["sha256", "blake2s256"])
def test_merkle_create_and_prove_batch_match_jax(algorithm):
    rng = np.random.default_rng(5)
    n = 32
    words = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64).astype(np.uint32)
    h, jh = create_hash(algorithm), jax_hash(algorithm)
    tree = MerkleTree.create(torch.from_numpy(words.astype(np.int64)).to(torch.int32), h)
    jtree = JaxTree.create(jnp.asarray(words), jh)
    assert (tree.root, tree.depth, tree.leaf_count) == (jtree.root, jtree.depth, n)
    host = MerkleTree.create_from_bytes([words[:, i].astype("<u4").tobytes()
                                         for i in range(n)], h)
    assert host.root == tree.root
    for positions in ([3], [0, 31, 7, 8, 9], list(range(0, n, 3))):
        got, want = tree.prove_batch(positions), jtree.prove_batch(positions)
        assert (got.values, got.nodes, got.depth) == (want.values, want.nodes, want.depth)
        assert MerkleTree.verify_batch(tree.root, positions, got, h)


def test_merge_element_rows_list_and_stacked_forms():
    field = create_prime_field(P128)
    rng = np.random.default_rng(3)
    dev = field.device_field("cpu")
    vecs = [dev.from_ints(_elements(rng, P128, (16,)), to_mont=False) for _ in range(3)]
    h = create_hash("blake2s256")
    got = h.merge_element_rows(vecs, field.element_size)
    assert torch.equal(got, h.merge_element_rows(torch.stack(vecs), field.element_size))
    want = jax_hash("blake2s256").merge_element_rows([_to_jax(v) for v in vecs],
                                                     field.element_size)
    assert _equal(got, want)


# ----- the staged-test configuration ------------------------------------------
def _foo_schema(steps=64):
    return JaxSchema(
        field=jax_field(P32),
        trace_width=1,
        static_registers=[JaxCyclic([1, 2, 3, 4])],
        init=[const(3)],
        transition=[trace(0) + const(2) + static(0)],
        constraints=[nxt(0) - (trace(0) + const(2) + static(0))],
        base_steps=steps,
        name="foo",
    )


def _foo_values(modulus, steps=64):
    ks = [1, 2, 3, 4]
    v, vals = 3, [3]
    for t in range(steps - 1):
        v = (v + 2 + ks[t % 4]) % modulus
        vals.append(v)
    return vals


@pytest.fixture(scope="module")
def foo():
    """Both packages' Starks over the staged-test AIR, its assertions, and
    the JAX `prove_staged`'s bytes and log lines."""
    import contextlib
    import io
    jlog = io.StringIO()
    jstark = jax_instantiate(_foo_schema(), options=OPTIONS, logger=JaxLogger())
    stark = instantiate(schema_from_reference(jstark.air.schema), "default", OPTIONS, Logger(),
                        device="cpu")
    vals = _foo_values(P32)
    jassert = [JaxAssertion(0, 0, vals[0]), JaxAssertion(63, 0, vals[63])]
    with contextlib.redirect_stdout(jlog):
        jbytes = jstark.serialize(jstark.prove_staged(jassert))
    return {"jstark": jstark, "stark": stark, "jassert": jassert,
            "assert": [Assertion(a.step, a.register, a.value) for a in jassert],
            "jbytes": jbytes, "jlog": jlog.getvalue()}


def _strip_times(text: str):
    return [re.sub(r" \(\d+ ms\)$| in \d+ ms$", "", line) for line in text.splitlines()]


def test_prove_staged_matches_jax_and_prove(foo, capsys):
    stark = foo["stark"]
    capsys.readouterr()
    staged = stark.serialize(stark.prove_staged(foo["assert"]))
    log = capsys.readouterr().out
    assert staged == foo["jbytes"]
    assert stark.serialize(stark.prove(foo["assert"])) == staged
    assert foo["jstark"].verify(foo["jassert"], foo["jstark"].parse(staged))
    assert stark.verify(foo["assert"], stark.parse(staged))
    # the log: the JAX path's messages, times aside
    assert _strip_times(log) == _strip_times(foo["jlog"])
    assert "  Computed FRI layer at depth 0" in _strip_times(log)


def _stage_inputs(foo):
    """The same stage inputs in both packages: trace polynomials and their
    evaluations, from each package's own context."""
    jctx = foo["jstark"].air.init_proving_context([], None)
    jp = jax_ntt.intt(jctx.field, jctx.generate_execution_trace())
    jpe = jax_ntt.low_degree_extend(jctx.field, jp, jctx.evaluation_domain_size)
    stark = foo["stark"]
    ctx = stark.air.init_proving_context([], None, dev=stark.dev)
    p = ntt.intt(ctx.field, ctx.generate_execution_trace())
    pe = ntt.low_degree_extend(ctx.field, p, ctx.evaluation_domain_size)
    assert _equal(p, jp) and _equal(pe, jpe)
    return jctx, jp, jpe, ctx, p, pe


def test_composition_lincomb_and_low_degree_prover_match_jax(foo):
    jctx, jp, jpe, ctx, p, pe = _stage_inputs(foo)
    jc = JaxComposition(foo["jassert"], SEED, jctx)
    c = CompositionPolynomial(foo["assert"], SEED, ctx)
    c_evals = c.evaluate_all(p, pe, ctx)
    jc_evals = jc.evaluate_all(jp, jpe, jctx)
    assert _equal(c_evals, jc_evals)

    s = ctx.secret_register_traces
    assert s == [] and jctx.secret_register_traces == []
    lc = LinearCombination(SEED, c.composition_degree, c.coefficient_count, ctx)
    jlc = JaxLinearCombination(SEED, jc.composition_degree, jc.coefficient_count, jctx)
    l_evals = lc.compute_many(c_evals, pe, s)
    jl_evals = jlc.compute_many(jc_evals, jpe, [])
    assert _equal(l_evals, jl_evals)

    stark, jstark = foo["stark"], foo["jstark"]
    got = LowDegreeProver(stark.index_generator, stark.hash, ctx).prove(
        l_evals, c.composition_degree)
    want = JaxLowDegreeProver(jstark.index_generator, jstark.hash, jctx).prove(
        jl_evals, jc.composition_degree)

    def fields(ld):
        proof = lambda b: (b.values, b.nodes, b.depth)
        return (ld.lc_root, proof(ld.lc_proof), ld.remainder,
                [(k.column_root, proof(k.column_proof), proof(k.poly_proof))
                 for k in ld.components])
    assert fields(got) == fields(want)
    assert len(got.components) == 1


def test_zero_and_boundary_polynomials_match_jax(foo):
    from genstark_tpu.protocol.boundary import BoundaryConstraints as JaxBoundary
    from genstark_tpu.protocol.zeropoly import ZeroPolynomial as JaxZero
    from genstark_tpu_torch.protocol.boundary import BoundaryConstraints
    from genstark_tpu_torch.protocol.zeropoly import ZeroPolynomial
    jctx, jp, _, ctx, p, _ = _stage_inputs(foo)
    Ne = ctx.evaluation_domain_size
    domain = ctx.field.device_field("cpu").power_series(ctx.root_of_unity, Ne)
    jdomain = jctx.field.device.power_series(jctx.root_of_unity, Ne)
    assert _equal(domain, jdomain)
    z, jz = ZeroPolynomial(ctx), JaxZero(jctx)
    for got, want in zip(z.evaluate_all(domain), jz.evaluate_all(jdomain)):
        assert _equal(got, want)
    assert _equal(z.evaluate_all_inverse(domain), jz.evaluate_all_inverse(jdomain))
    x = ctx.field.exp(ctx.root_of_unity, 3)
    assert z.evaluate_at(x) == jz.evaluate_at(x)
    b = BoundaryConstraints(foo["assert"], ctx).evaluate_all(p, Ne)
    jb = JaxBoundary(foo["jassert"], jctx).evaluate_all(jp, Ne)
    assert len(b) == len(jb) == 1 and _equal(b[0], jb[0])


def test_context_device_trace_and_constraints_match_jax(foo):
    jctx, jp, _, ctx, p, _ = _stage_inputs(foo)
    assert _equal(ctx.generate_execution_trace(), jctx.generate_execution_trace())
    assert _equal(ctx.static_device, jctx.static_device)
    assert _equal(ctx.evaluate_transition_constraints(p),
                  jctx.evaluate_transition_constraints(jp))
    trace_, context = foo["stark"].generate_execution_trace([], None)
    assert torch.equal(trace_, ctx.generate_execution_trace())
    assert context.trace_source == "native"


@pytest.mark.parametrize("modulus,count,pin", [
    (P32, 16, (3472, "db79f92d")), (P128, 32, (7329, "3fa3bc9f"))], ids=["p32", "p128"])
def test_prove_staged_reproduces_the_pins(modulus, count, pin):
    import hashlib
    stark, data = prove_mimc(64, "cpu", modulus=modulus, use_input=False,
                             constant_count=count, options=TOY)
    controls = run_mimc(stark.air.field, 64, stark.air.schema.static_registers[0].values, 3)
    assertions = [Assertion(0, 0, controls[0]), Assertion(63, 0, controls[-1])]
    staged = stark.serialize(stark.prove_staged(assertions, [], [3]))
    assert staged == data
    assert (len(staged), hashlib.sha256(staged).hexdigest()[:8]) == pin


def test_prove_staged_errors(foo):
    stark = foo["stark"]
    with pytest.raises(TypeError):
        stark.prove_staged([])
    with pytest.raises(TypeError):
        foo["jstark"].prove_staged([])
    bad = [Assertion(0, 0, 4)]
    with pytest.raises(StarkError, match="conflicts with execution trace"):
        stark.prove_staged(bad)
    from genstark_tpu.protocol.fri import StarkError as JaxStarkError
    with pytest.raises(JaxStarkError, match="conflicts with execution trace"):
        foo["jstark"].prove_staged([JaxAssertion(0, 0, 4)])
    # a step outside the trace: a ValueError, wrapped as in the JAX package
    with pytest.raises(StarkError, match="Failed to generate") as info:
        stark.prove_staged([Assertion(64, 0, 1)])
    assert "outside of execution trace" in str(info.value.__cause__)
    with pytest.raises(JaxStarkError, match="Failed to generate") as info:
        foo["jstark"].prove_staged([JaxAssertion(64, 0, 1)])
    assert "outside of execution trace" in str(info.value.__cause__)


def test_prove_staged_wraps_failures(foo, monkeypatch):
    """A failing trace or low-degree proof raises the JAX package's
    StarkError messages, with the cause chained."""
    stark = foo["stark"]
    from genstark_tpu_torch.air.module import ProvingContext
    monkeypatch.setattr(ProvingContext, "generate_execution_trace",
                        lambda self: 1 / 0)
    with pytest.raises(StarkError, match="Failed to generate the execution trace"):
        stark.prove_staged(foo["assert"])
    monkeypatch.undo()
    monkeypatch.setattr(LowDegreeProver, "prove", lambda self, *a: 1 / 0)
    with pytest.raises(StarkError, match="Low degree proof failed") as info:
        stark.prove_staged(foo["assert"])
    assert isinstance(info.value.__cause__, ZeroDivisionError)


def test_logger_sub_and_noop(capsys):
    from genstark_tpu_torch.utils import NoopLogger, is_power_of_2, noop_logger
    logger = Logger(enable_sub_logs=False)
    log = logger.start("top")
    sub = logger.sub("hidden")
    sub("not printed")
    logger.done(sub)
    log("step")
    logger.done(log, "all")
    assert _strip_times(capsys.readouterr().out) == ["top", "step", "all"]
    noop_logger.start("x")("y")
    assert isinstance(noop_logger, NoopLogger) and capsys.readouterr().out == ""
    assert [is_power_of_2(v) for v in (0, 1, 6, 64)] == [False, True, False, True]


def test_field_surface():
    field = create_prime_field(P32)
    p = field.modulus
    assert (field.sub(1, 2), field.mul(p - 1, p - 1), field.neg(5)) == (p - 1, 1, p - 5)
    assert field.mul(field.div(7, 3), 3) == 7
    assert field.from_bytes(field.to_bytes(p - 1)) == p - 1 and len(field.to_bytes(1)) == 4
    assert (field.one, field.zero) == (1, 0)
    assert field.get_power_series(3, 4) == [1, 3, 9, 27] and 0 <= field.rand() < p
    dev = field.device_field("cpu")
    assert dev is field.device_field(torch.device("cpu"))
    a, b = dev.from_ints([5, p - 1]), dev.from_ints([p - 2, 3])
    assert dev.to_ints(dev.add(a, b)) == [3, 2]
    assert dev.to_ints(dev.sub(a, b)) == [7, p - 4]
    assert dev.to_ints(dev.neg(a)) == [p - 5, 1]
    assert dev.to_ints(dev.mul(a, b)) == [5 * (p - 2) % p, p - 3]
    assert dev.to_ints(dev.sqr(b)) == [4, 9]
    assert torch.equal(dev.to_mont(dev.from_mont(a)), a)
    assert dev.to_ints(dev.power_series(3, 5)) == [1, 3, 9, 27, 81]
    assert dev.to_ints(dev.combine_many([a, b], [2, 10])) == [
        (10 + 10 * (p - 2)) % p, (2 * (p - 1) + 30) % p]
