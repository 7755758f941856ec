"""The port's whole prover on the CPU: the pinned proof digests, byte
identity with the JAX package's prover on the same AIR (converted from the
JAX schema), and the JAX verifier accepting the port's bytes."""

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

TOY = {"extension_factor": 4, "exe_query_count": 8, "fri_query_count": 6}


def _digest(data: bytes):
    return len(data), hashlib.sha256(data).hexdigest()


def test_p32_golden_pin():
    # tests/test_compat_vectors.py::test_golden_proof_bytes
    _, data = prove_mimc(64, "cpu", modulus=P32, use_input=False, constant_count=16,
                         options=TOY)
    assert _digest(data) == (
        3472, "db79f92dcacf2cf2d1eeb7cee8db4a4eeb1e5bc5f4d13e9b0cdaacab7cc95b75")


def test_p128_pin():
    # tests/test_mxu_prover.py::test_mxu_proof_bytes_match_default
    _, data = prove_mimc(64, "cpu", modulus=P128, use_input=False, constant_count=32,
                         options=TOY)
    assert _digest(data) == (
        7329, "3fa3bc9f84d3505912258df9974587b18b35619116a2787786b3beacd3cc4917")


def test_secret_input_proof_equals_jax_and_verifies():
    """The bench's shape (p128, blake2s256, ext 16, 48/24 queries, secret
    input register) at 64 steps: the JAX schema converted to the port's, both
    packages prove, the bytes are equal, and the JAX verifier accepts them."""
    jstark, constants = jax_make_mimc_stark(64, use_input=True)
    controls = jax_run_mimc(jstark.air.field, 64, constants, 3)
    jassert = [JaxAssertion(0, 0, controls[0]), JaxAssertion(63, 0, controls[-1])]
    want = jstark.serialize(jstark.prove(jassert, [[3]]))

    stark = instantiate(schema_from_reference(jstark.air.schema), "default",
                        {"hash_algorithm": "blake2s256", "extension_factor": 16,
                         "exe_query_count": 48, "fri_query_count": 24}, device="cpu")
    proof = stark.prove([Assertion(a.step, a.register, a.value) for a in jassert], [[3]])
    got = stark.serialize(proof)
    assert _digest(got) == _digest(want)
    assert stark.size_of(proof) == len(got)
    assert stark.security_level == jstark.security_level
    assert jstark.verify(jassert, jstark.parse(got))


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
    """Recompute the bench-config pin of chip_smoke.py with the JAX package
    (MiMC-128, 2^13 steps, secret input 3; several minutes on the CPU)."""
    import chip_smoke
    steps = 2 ** 13
    jstark, constants = jax_make_mimc_stark(steps, use_input=True)
    controls = jax_run_mimc(jstark.air.field, steps, constants, 3)
    jassert = [JaxAssertion(0, 0, controls[0]), JaxAssertion(steps - 1, 0, controls[-1])]
    data = jstark.serialize(jstark.prove(jassert, [[3]]))
    assert _digest(data) == chip_smoke.BENCH_PIN
