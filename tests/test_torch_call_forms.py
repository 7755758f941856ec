"""The JAX package's call forms run on the port unchanged, with the device
added as a keyword: `instantiate(src, "default", options, logger)`,
`instantiate_script(src, options, logger)`, `Stark(air, options, logger)`
and `LinearCombination(seed, degree, offset, context)` give the JAX
package's proof bytes and values; the verifier's `evaluate_at` computes its
own inverses when given none; a proving context without a DeviceField
takes the field's card (`PrimeField.device`) when it first needs one.
Toy AIRs over p32, exact comparisons."""

import contextlib
import io

import pytest
import torch

from genstark_tpu import instantiate as jax_instantiate
from genstark_tpu import instantiate_script as jax_instantiate_script
from genstark_tpu.protocol import Assertion as JaxAssertion
from genstark_tpu.protocol.lincomb import LinearCombination as JaxLinearCombination
from genstark_tpu.utils import Logger as JaxLogger
from genstark_tpu_torch import Logger, instantiate, instantiate_script
from genstark_tpu_torch.air import AirModule
from genstark_tpu_torch.air.script import compile_script
from genstark_tpu_torch.field import P32, create_prime_field
from genstark_tpu_torch.protocol import Assertion, Stark
from genstark_tpu_torch.protocol.lincomb import LinearCombination

OPTIONS = {"extension_factor": 4, "exe_query_count": 8, "fri_query_count": 6}
FOO_SCRIPT = """
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
FOO_AA = """
(module
    (field prime 4194304001)
    (export default
        (registers 1) (constraints 1) (steps 64)
        (init
            (param $seed vector 1)
            (load.param $seed))
        (transition
            (add (exp (load.trace 0) (scalar 3)) (scalar 2)))
        (evaluation
            (sub
                (load.trace 1)
                (add (exp (load.trace 0) (scalar 3)) (scalar 2))))))
"""
SCRIPT_ASSERTIONS = [(0, 0, 1), (63, 0, 127)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _aa_assertions():
    p, v = P32, [3]
    for _ in range(63):
        v.append((v[-1] ** 3 + 2) % p)
    return [(0, 0, v[0]), (63, 0, v[-1])]


def _prove(stark, points, assertion, inputs, seed=None):
    with contextlib.redirect_stdout(io.StringIO()):
        return stark.serialize(stark.prove([assertion(*a) for a in points], inputs, seed))


@pytest.fixture(scope="module")
def jax_script_proof():
    stark = jax_instantiate_script(FOO_SCRIPT, dict(OPTIONS), JaxLogger())
    return _prove(stark, SCRIPT_ASSERTIONS, JaxAssertion, [[1]])


def test_instantiate_in_the_jax_form():
    points = _aa_assertions()
    want = _prove(jax_instantiate(FOO_AA, "default", dict(OPTIONS), JaxLogger()),
                  points, JaxAssertion, [], [3])
    got = _prove(instantiate(FOO_AA, "default", dict(OPTIONS), Logger(), device="cpu"),
                 points, Assertion, [], [3])
    assert got == want


def test_instantiate_script_in_the_jax_form(jax_script_proof):
    stark = instantiate_script(FOO_SCRIPT, dict(OPTIONS), Logger(), device="cpu")
    assert stark.dev.device.type == "cpu"
    assert _prove(stark, SCRIPT_ASSERTIONS, Assertion, [[1]]) == jax_script_proof


def test_stark_in_the_jax_form(jax_script_proof):
    air = AirModule(compile_script(FOO_SCRIPT), extension_factor=OPTIONS["extension_factor"])
    stark = Stark(air, dict(OPTIONS), Logger(), device="cpu")
    assert _prove(stark, SCRIPT_ASSERTIONS, Assertion, [[1]]) == jax_script_proof


def _contexts():
    jstark = jax_instantiate_script(FOO_SCRIPT, dict(OPTIONS))
    stark = instantiate_script(FOO_SCRIPT, dict(OPTIONS), device="cpu")
    return (jstark, jstark.air.init_verification_context([[1]]),
            stark, stark.air.init_verification_context([[1]]))


def test_linear_combination_in_the_jax_form():
    _, jctx, _, ctx = _contexts()
    seed, degree, offset = bytes(range(32)), 128, 5
    jlc = JaxLinearCombination(seed, degree, offset, jctx)
    lc = LinearCombination(seed, degree, offset, ctx)
    assert lc._get_coefficients(4) == jlc._get_coefficients(4)
    f = create_prime_field(P32)
    x, d, ps = f.host.exp(7, 3), 11, [13]
    assert lc.compute_one(x, d, ps, []) == jlc.compute_one(x, d, ps, [])


def test_evaluate_at_without_inverses():
    """The verifier's point evaluation with no inverses given divides on
    the host, as the JAX package does; with the batched inverses it gives
    the same values."""
    from genstark_tpu.protocol.composition import CompositionPolynomial as JaxComposition
    from genstark_tpu_torch.protocol.composition import CompositionPolynomial
    jstark, jctx, _, ctx = _contexts()
    seed = bytes(range(32))
    points = [(0, 0, 1), (63, 0, 127), (31, 0, 63)]
    jc = JaxComposition([JaxAssertion(*a) for a in points], seed, jctx)
    c = CompositionPolynomial([Assertion(*a) for a in points], seed, ctx)
    f = ctx.field.host
    for x in (5, 1234567, P32 - 2):
        p, n, s = [f.exp(x, 2)], [f.add(x, 9)], [17]
        assert c.b_poly.evaluate_at(p, x) == jc.b_poly.evaluate_at(p, x)
        assert c.evaluate_at(x, p, n, s, ctx) == jc.evaluate_at(x, p, n, s, jctx)
        z_invs = [f.inv(z) for z in c.b_poly.z_dens_at(x)]
        invs = (f.inv(c.z_poly.evaluate_at(x)), z_invs)
        assert c.evaluate_at(x, p, n, s, ctx, invs) == c.evaluate_at(x, p, n, s, ctx)


def test_proving_context_takes_the_card_by_default(monkeypatch):
    """`init_proving_context(inputs, seed)` keeps no DeviceField and takes
    `PrimeField.device` (the card's) when it first needs one: here, where
    there is no card, that raises as `device_field("cuda")` does; with the
    property pointed at the CPU the JAX form gives the trace of the
    explicit form."""
    air = instantiate_script(FOO_SCRIPT, dict(OPTIONS), device="cpu").air
    field = air.field
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            field.device_field("cuda")
        with pytest.raises((AssertionError, RuntimeError)):
            field.device
        with pytest.raises((AssertionError, RuntimeError)):
            air.init_proving_context([[1]]).generate_execution_trace()
    want = air.init_proving_context([[1]], dev=field.device_field("cpu"))
    monkeypatch.setattr(type(field), "device", property(lambda self: self.device_field("cpu")))
    ctx = air.init_proving_context([[1]])
    assert ctx.dev is None
    assert torch.equal(ctx.generate_execution_trace(), want.generate_execution_trace())
    assert ctx.dev is field.device_field("cpu")
