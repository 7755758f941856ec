"""The port's batched inverse and division by a register against the JAX
package: `inv_ref` against JAX `DeviceField.inv` on the same numpy limbs
(exact, inv(0) = 0 included), a toy AIR whose constraint divides by a
register proved by the port to the JAX package's bytes (DIV_PIN, which a
`slow` test remakes with the JAX package; the JAX verifier accepts them),
and bad assertions raising `StarkError` in both."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest

from examples.mimc import make_mimc_stark as jax_make_mimc_stark
from examples.mimc import round_constants as jax_round_constants
from examples.mimc import run_mimc as jax_run_mimc
from examples.mimc_torch import (DIVISORS, make_div_stark, make_mimc_stark, prove_div,
                                  prove_mimc, run_mimc)
from genstark_tpu import instantiate as jax_instantiate
from genstark_tpu.air import AirSchema as JaxAirSchema
from genstark_tpu.air import CyclicRegister as JaxCyclicRegister
from genstark_tpu.air.ir import nxt as jnxt, seed as jseed, static as jstatic, trace as jtrace
from genstark_tpu.field import create_prime_field as jax_field
from genstark_tpu.protocol import Assertion as JaxAssertion
from genstark_tpu.protocol import StarkError as JaxStarkError
from genstark_tpu_torch.air.convert import schema_from_reference
from genstark_tpu_torch.field import P32, P64, P128, P256, create_prime_field
from genstark_tpu_torch.protocol import Assertion, StarkError
from genstark_tpu_torch.testing import DIV_PIN

TOY = {"extension_factor": 4, "exe_query_count": 8, "fri_query_count": 6}


def _elements(rng, modulus, n, zeros=()):
    """u32 [L, n] canonical Montgomery-form limbs, zero at `zeros`."""
    L = create_prime_field(modulus).params.L
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, modulus >> (16 * (L - 1)), size=n)
    limbs[:, list(zeros)] = 0
    return limbs.astype(np.uint32)


@pytest.mark.parametrize("modulus", [P32, P64, P128], ids=["p32", "p64", "p128"])
def test_inv_ref_matches_jax(modulus):
    """N = 64 with zeros (first, last and inside), then a batched [L, 3, 16]."""
    dev = create_prime_field(modulus).device_field("cpu")
    jdev = jax_field(modulus).device
    rng = np.random.default_rng(modulus % 1009)
    for shape, zeros in (((64,), (0, 5, 6, 40, 63)), ((3, 16), (2, 17, 47))):
        a = _elements(rng, modulus, int(np.prod(shape)), zeros).reshape((dev.L,) + shape)
        got = dev.inv_ref(dev.from_numpy(a)).numpy().astype(np.uint32)
        want = np.asarray(jdev.inv(jnp.asarray(a))).astype(np.uint32)
        assert got.shape == want.shape == a.shape
        assert np.array_equal(got, want)
        flat = got.reshape(dev.L, -1)
        assert not flat[:, list(zeros)].any()
        # the public op takes the plain version on a CPU tensor
        assert np.array_equal(dev.inv(dev.from_numpy(a)).numpy().astype(np.uint32), got)


def test_inv_ref_p256_against_python():
    """P256 against pow(x, p-2, p) on the standard values (no wide-field
    XLA compile): a Montgomery input xR gives x^-1 R."""
    field = create_prime_field(P256)
    dev = field.device_field("cpu")
    p = field.modulus
    rng = np.random.default_rng(256)
    values = [int(v) % p for v in rng.integers(1, 2 ** 62, size=37)] + [0, 1, p - 1, 0]
    got = dev.to_ints(dev.inv_ref(dev.from_ints(values)))
    assert got == [pow(v, p - 2, p) if v else 0 for v in values]
    single = dev.to_ints(dev.inv_ref(dev.from_ints(values[:1])))
    assert single == [pow(values[0], p - 2, p)]


def _jax_div_stark(steps):
    """The JAX package's twin of examples/mimc_torch.make_div_stark."""
    field = jax_field(P128)
    constants = jax_round_constants(field, 16)
    schema = JaxAirSchema(
        field=field, trace_width=1,
        static_registers=[JaxCyclicRegister(DIVISORS), JaxCyclicRegister(constants)],
        init=[jseed(0)], transition=[jtrace(0) ** 3 + jstatic(1)],
        constraints=[(jnxt(0) * jstatic(0)) / jstatic(0) - (jtrace(0) ** 3 + jstatic(1))],
        base_steps=steps, name="mimc_div")
    options = {"hash_algorithm": "blake2s256", **TOY}
    return jax_instantiate(schema, options=options), constants


def test_division_by_register_proof_equals_jax_and_verifies():
    """A 64-step AIR whose constraint divides by a register: the JAX schema
    converted equals the port's own, the port proves the JAX package's
    bytes (DIV_PIN), the JAX verifier accepts them, and they equal plain
    MiMC's over the same constants."""
    steps = 64
    jstark, constants = _jax_div_stark(steps)
    stark, own_constants = make_div_stark(steps, "cpu")
    assert [int(c) for c in constants] == own_constants
    conv = schema_from_reference(jstark.air.schema)
    assert repr(conv.constraints) == repr(stark.air.schema.constraints)
    assert repr(conv.transition) == repr(stark.air.schema.transition)
    assert conv.constraint_degrees == stark.air.schema.constraint_degrees == [3]

    controls = jax_run_mimc(jstark.air.field, steps, constants, 3)
    jassert = [JaxAssertion(0, 0, controls[0]), JaxAssertion(steps - 1, 0, controls[-1])]
    _, got = prove_div(steps, "cpu")
    assert (len(got), hashlib.sha256(got).hexdigest()) == DIV_PIN
    assert jstark.verify(jassert, jstark.parse(got))
    # the quotient is nxt(0) wherever the divisor is nonzero: plain MiMC's bytes
    _, plain = prove_mimc(steps, "cpu", modulus=P128, use_input=False, constant_count=16,
                          options=TOY)
    assert plain == got


@pytest.mark.slow
def test_division_pin_is_the_jax_packages():
    """The JAX package proves the division AIR's statement to DIV_PIN (about
    two minutes of XLA:CPU)."""
    steps = 64
    jstark, constants = _jax_div_stark(steps)
    controls = jax_run_mimc(jstark.air.field, steps, constants, 3)
    jassert = [JaxAssertion(0, 0, controls[0]), JaxAssertion(steps - 1, 0, controls[-1])]
    data = jstark.serialize(jstark.prove(jassert, [], [3]))
    assert (len(data), hashlib.sha256(data).hexdigest()) == DIV_PIN


@pytest.mark.parametrize("where", ["register", "step"])
def test_bad_assertion_raises_stark_error_in_both(where):
    """An assertion whose register or step is out of range raises StarkError
    ("Failed to generate the execution trace") caused by a ValueError, in
    the port as in the JAX package."""
    steps = 64
    bad = {"register": (0, 5), "step": (steps, 0)}[where]
    stark, constants = make_mimc_stark(steps, "cpu", options=TOY)
    controls = run_mimc(stark.air.field, steps, constants, 3)
    with pytest.raises(StarkError, match="execution trace") as port_err:
        stark.prove([Assertion(0, 0, controls[0]), Assertion(*bad, 1)], [[3]])
    jstark, jconstants = jax_make_mimc_stark(steps, options=TOY)
    jcontrols = jax_run_mimc(jstark.air.field, steps, jconstants, 3)
    with pytest.raises(JaxStarkError, match="execution trace") as jax_err:
        jstark.prove([JaxAssertion(0, 0, jcontrols[0]), JaxAssertion(*bad, 1)], [[3]])
    assert type(port_err.value.__cause__) is type(jax_err.value.__cause__) is ValueError
    assert str(port_err.value.__cause__) == str(jax_err.value.__cause__)
