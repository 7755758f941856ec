"""The port's whole prover on the CPU: the pinned proof digests, byte
identity with the JAX package's prover on the same AIR (converted from the
JAX schema; the JAX package's bytes pinned, and remade by the `slow`
tests), and the JAX verifier accepting the port's bytes."""

import hashlib

import pytest

from examples.mimc import make_mimc_stark as jax_make_mimc_stark
from examples.mimc import run_mimc as jax_run_mimc
from examples.mimc_torch import make_mimc_stark, prove_mimc, run_mimc
from genstark_tpu.protocol import Assertion as JaxAssertion
from genstark_tpu_torch import air, instantiate
from genstark_tpu_torch.air.convert import schema_from_reference
from genstark_tpu_torch.field import P32, P128
from genstark_tpu_torch.protocol import Assertion
from genstark_tpu_torch.testing import BENCH_PIN, BENCH_STEPS, P32_PIN, P128_PIN

TOY = {"extension_factor": 4, "exe_query_count": 8, "fri_query_count": 6}
# MiMC-128, 64 steps, secret input 3, the bench options (blake2s256, ext 16,
# 48/24 queries): the JAX package's proof on the CPU.
SECRET_INPUT_PIN = (27404, "f3cffb1cae924bb21ac2c64374479501416a8f73b66e61be1e7bdef164d09ad7")


def _digest(data: bytes):
    return len(data), hashlib.sha256(data).hexdigest()


def test_p32_golden_pin():
    # tests/test_compat_vectors.py::test_golden_proof_bytes
    _, data = prove_mimc(64, "cpu", modulus=P32, use_input=False, constant_count=16,
                         options=TOY)
    assert _digest(data) == P32_PIN


def test_p128_pin():
    # tests/test_mxu_prover.py::test_mxu_proof_bytes_match_default
    _, data = prove_mimc(64, "cpu", modulus=P128, use_input=False, constant_count=32,
                         options=TOY)
    assert _digest(data) == P128_PIN


def _jax_secret_input(steps: int):
    """The JAX package's bench-shape MiMC Stark and its assertions of seed 3."""
    jstark, constants = jax_make_mimc_stark(steps, use_input=True)
    controls = jax_run_mimc(jstark.air.field, steps, constants, 3)
    return jstark, [JaxAssertion(0, 0, controls[0]), JaxAssertion(steps - 1, 0, controls[-1])]


def test_secret_input_proof_equals_jax_and_verifies():
    """The bench's shape (p128, blake2s256, ext 16, 48/24 queries, secret
    input register) at 64 steps: the JAX schema converted to the port's, the
    port's bytes are the JAX package's (SECRET_INPUT_PIN), and the JAX
    verifier accepts them."""
    jstark, jassert = _jax_secret_input(64)
    stark = instantiate(schema_from_reference(jstark.air.schema), "default",
                        {"hash_algorithm": "blake2s256", "extension_factor": 16,
                         "exe_query_count": 48, "fri_query_count": 24}, device="cpu")
    proof = stark.prove([Assertion(a.step, a.register, a.value) for a in jassert], [[3]])
    got = stark.serialize(proof)
    assert _digest(got) == SECRET_INPUT_PIN
    assert stark.size_of(proof) == len(got)
    assert stark.security_level == jstark.security_level
    assert jstark.verify(jassert, jstark.parse(got))


@pytest.mark.slow
def test_secret_input_pin_is_the_jax_packages():
    """The JAX package proves the statement of
    test_secret_input_proof_equals_jax_and_verifies to SECRET_INPUT_PIN
    (some minutes of XLA:CPU)."""
    jstark, jassert = _jax_secret_input(64)
    assert _digest(jstark.serialize(jstark.prove(jassert, [[3]]))) == SECRET_INPUT_PIN


def test_schema_converter():
    jstark, _ = jax_make_mimc_stark(64, use_input=True)
    ref = jstark.air.schema
    conv = schema_from_reference(ref)
    assert conv.field.modulus == ref.field.modulus
    assert conv.trace_width == ref.trace_width and conv.base_steps == ref.base_steps
    assert [type(r).__name__ for r in conv.static_registers] == \
        ["CyclicRegister", "InputRegister"]
    assert conv.static_registers[0].values == ref.static_registers[0].values
    assert conv.static_registers[1].secret is True
    assert conv.constraint_degrees == ref.constraint_degrees == [3]
    # the converted DAG keeps shared nodes shared and equals the port's own AIR
    own, _ = make_mimc_stark(64, "cpu")
    assert repr(conv.transition) == repr(own.air.schema.transition)
    assert repr(conv.constraints) == repr(own.air.schema.constraints)
    assert isinstance(conv.static_registers[1], air.InputRegister)


def test_assertion_conflict_raises():
    from genstark_tpu_torch.protocol import StarkError
    stark, constants = make_mimc_stark(64, "cpu", options=TOY)
    controls = run_mimc(stark.air.field, 64, constants, 3)
    with pytest.raises(StarkError):
        stark.prove([Assertion(0, 0, controls[0] + 1)], [[3]])
    with pytest.raises(TypeError):
        stark.prove([], [[3]])


@pytest.mark.slow
def test_bench_pin_matches_jax():
    """Recompute BENCH_PIN with the JAX package (MiMC-128, 2^13 steps,
    secret input 3; several minutes on the CPU)."""
    jstark, jassert = _jax_secret_input(BENCH_STEPS)
    data = jstark.serialize(jstark.prove(jassert, [[3]]))
    assert _digest(data) == BENCH_PIN
