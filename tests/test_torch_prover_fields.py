"""The port's whole prover over fields the digit DFT does not take: MiMC
over P256 (the reference's mimc256) and over P64, at 64 steps, on the
radix-2 path.

In tier-1 the port's bytes are held to pins that the JAX package made once
on the CPU (a live JAX prove of a 256-bit field costs minutes there); the
AIR is the JAX package's schema converted by `air/convert.py`, and the
port's own example AIR.  The `slow` tests recompute every pin with the JAX
package, the MiMC-256 2^13-step pin included, and check
that the JAX verifier accepts the port's bytes."""

import hashlib

import pytest

from examples.mimc import make_mimc_stark as jax_make_mimc_stark
from examples.mimc import run_mimc as jax_run_mimc
from examples.mimc_torch import prove_mimc
from genstark_tpu.protocol import Assertion as JaxAssertion
from genstark_tpu_torch import instantiate
from genstark_tpu_torch.air.convert import schema_from_reference
from genstark_tpu_torch.field import P64, P256
from genstark_tpu_torch.protocol import Assertion
from genstark_tpu_torch.testing import BENCH_STEPS, MIMC256_PIN, P64_64_PIN, P256_64_PIN

BENCH = {"hash_algorithm": "blake2s256", "extension_factor": 16,
         "exe_query_count": 48, "fri_query_count": 24}
TOY = dict(BENCH, extension_factor=4, exe_query_count=8, fri_query_count=6)

# (modulus, options, (bytes, sha256) of the JAX package's proof): MiMC,
# 64 steps, 64 cyclic constants, secret input 3.
CASES = {
    "p256": (P256, BENCH, P256_64_PIN),
    "p64": (P64, TOY, P64_64_PIN),
}


def _digest(data: bytes):
    return len(data), hashlib.sha256(data).hexdigest()


def _jax_mimc(steps, modulus, options):
    """The JAX package's stark, assertions and secret input for one run."""
    jstark, constants = jax_make_mimc_stark(steps, modulus, use_input=True, options=options)
    controls = jax_run_mimc(jstark.air.field, steps, constants, 3)
    return jstark, [JaxAssertion(0, 0, controls[0]), JaxAssertion(steps - 1, 0, controls[-1])]


def _port_proof_of_jax_schema(jstark, jassert, options):
    stark = instantiate(schema_from_reference(jstark.air.schema), "default", options, device="cpu")
    proof = stark.prove([Assertion(a.step, a.register, a.value) for a in jassert], [[3]])
    data = stark.serialize(proof)
    assert stark.size_of(proof) == len(data)
    assert stark.security_level == jstark.security_level
    return data


@pytest.mark.parametrize("case", sorted(CASES))
def test_converted_jax_schema_proof_equals_pin(case):
    modulus, options, pin = CASES[case]
    jstark, jassert = _jax_mimc(64, modulus, options)
    assert _digest(_port_proof_of_jax_schema(jstark, jassert, options)) == pin


@pytest.mark.parametrize("case", sorted(CASES))
def test_example_air_proof_equals_pin(case):
    modulus, options, pin = CASES[case]
    _, data = prove_mimc(64, "cpu", modulus=modulus, options=options)
    assert _digest(data) == pin


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(CASES))
def test_pins_match_jax_and_jax_verifies_port_bytes(case):
    """Recompute the 64-step pins with the JAX package (minutes for p256
    on the CPU), and verify the port's bytes with the JAX verifier."""
    modulus, options, pin = CASES[case]
    jstark, jassert = _jax_mimc(64, modulus, options)
    assert _digest(jstark.serialize(jstark.prove(jassert, [[3]]))) == pin
    got = _port_proof_of_jax_schema(jstark, jassert, options)
    assert jstark.verify(jassert, jstark.parse(got))


@pytest.mark.slow
def test_mimc256_pin_matches_jax():
    """Recompute MIMC256_PIN with the JAX package (MiMC-256,
    2^13 steps, the bench options, secret input 3; over half an hour of
    XLA:CPU compilation), and check the port's CPU proof against it."""
    steps = BENCH_STEPS
    jstark, jassert = _jax_mimc(steps, P256, BENCH)
    data = jstark.serialize(jstark.prove(jassert, [[3]]))
    assert _digest(data) == MIMC256_PIN
    _, port = prove_mimc(steps, "cpu", modulus=P256)
    assert port == data
    assert jstark.verify(jassert, jstark.parse(port))
