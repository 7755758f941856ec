"""The reference's fibonacci and static-variables demos on the port
(examples/fibonacci_torch.py, examples/demo_static_torch.py) on the CPU:
the reference's oracle values, proof bytes equal to the JAX examples'
(pinned as sha256 digests of the JAX package's proofs on the CPU; the
`slow` test recomputes them live), `prove_staged` equal to `prove`, and
both packages' verifiers accepting the port's bytes."""

import hashlib

import pytest
import torch

from examples import demo_static, demo_static_torch, fibonacci, fibonacci_torch
from genstark_tpu.protocol import Assertion as JaxAssertion
from genstark_tpu_torch.testing import DEMO_PIN, FIB_PIN, FIB_STEPS

# (bytes, sha256) of the JAX example's proof of the fibonacci at 2^6 steps,
# default options (the demo's at 64 steps is DEMO_PIN, the fibonacci's at
# 2^17 steps FIB_PIN).
FIB64_PIN = (7162, "08eaf79fc7d841e972e10a545006912aa1f982a1a59ed6873eb673394d56b92d")

CASES = {
    "fibonacci": (lambda: fibonacci_torch.fib_case(2 ** 6, device="cpu"),
                  lambda: fibonacci.make_fib_stark(2 ** 6), FIB64_PIN),
    "demo_static": (lambda: demo_static_torch.demo_case(64, device="cpu"),
                    lambda: demo_static.make_demo_stark(64), DEMO_PIN),
}


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _digest(data: bytes):
    return len(data), hashlib.sha256(data).hexdigest()


def _jax_assertions(assertions):
    return [JaxAssertion(a.step, a.register, a.value) for a in assertions]


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_proves_to_the_jax_bytes(name):
    case, jax_stark, pin = CASES[name]
    stark, assertions, inputs = case()
    data = stark.serialize(stark.prove(assertions, inputs))
    assert _digest(data) == pin
    assert stark.serialize(stark.prove_staged(assertions, inputs)) == data
    assert stark.last_context.trace_source == "native"
    assert stark.verify(assertions, stark.parse(data))
    jstark = jax_stark()
    assert jstark.verify(_jax_assertions(assertions), jstark.parse(data))


def test_oracle_values():
    f = fibonacci_torch.make_fib_stark(64, device="cpu").air.field
    for steps, want in fibonacci_torch.EXPECTED.items():
        assert fibonacci_torch.run_fibonacci(f, steps, 1)[-1][1] == want
    assert fibonacci_torch.EXPECTED == fibonacci.EXPECTED
    d = demo_static_torch.make_demo_stark(64, device="cpu").air.field
    assert demo_static_torch.run_demo(d, 64, 1)[-1] == demo_static_torch.EXPECTED_RESULT == 780
    # the demo's field: 16-bit limbs, L = 2, not of solinas form, 2-adicity 9
    assert (d.params.L, d.element_size, d.host.two_adicity) == (2, 4, 9)


@pytest.mark.parametrize("module", [fibonacci_torch, demo_static_torch],
                         ids=["fibonacci", "demo_static"])
def test_run_entry_point(module, capsys):
    from genstark_tpu_torch.utils import Logger
    out = module.run(64, logger=Logger(), device="cpu", staged=True)
    assert out["proof_bytes"] in (FIB64_PIN[0], DEMO_PIN[0])
    assert "STARK computed in" in capsys.readouterr().out


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CASES))
def test_pins_match_jax(name):
    """Recompute the pins with the JAX examples (about 40 s each of XLA:CPU)."""
    case, jax_stark, pin = CASES[name]
    _, assertions, inputs = case()
    jstark = jax_stark()
    data = jstark.serialize(jstark.prove(_jax_assertions(assertions), inputs))
    assert _digest(data) == pin


@pytest.mark.slow
def test_fibonacci_2_17_pin_matches_jax():
    """FIB_PIN, the fibonacci at the reference's largest size
    (2^17 steps, Ne = 2^19): the JAX example's proof (about 4-5 min of
    XLA:CPU and 3.3 GiB) and the port's on the CPU (some 15 s)."""
    steps = FIB_STEPS
    stark, assertions, inputs = fibonacci_torch.fib_case(steps, device="cpu")
    assert _digest(stark.serialize(stark.prove(assertions, inputs))) == FIB_PIN
    jstark = fibonacci.make_fib_stark(steps)
    data = jstark.serialize(jstark.prove(_jax_assertions(assertions), inputs))
    assert _digest(data) == FIB_PIN
