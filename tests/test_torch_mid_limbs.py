"""The limb counts 6, 10 and 12: moduli of 65-96, 129-160 and 161-192 bits.

The JAX `PrimeField` takes any modulus; the port's kernels are built for
every L up to 16.  Over the solinas moduli of 96, 160 and 192 bits
(`testing.SOLINAS96` / `160` / `192`, the digit route at L = 6, 10 and 12),
on the CPU, where every wrapper runs its kernel's plain version:

- a multi-level transform through the DFT levels (`run_dft_level_ref`)
  against the radix-2 route's plain transform and the JAX package's default
  `ntt` / `intt` on the same numpy inputs, tolerance 0;
- the plain versions of kernels 5 (mul, add, sub), 6 (`outer_table`) and A
  (`mont_pow_ref(x, p - 2)`, the batched `inv`) with the edge values
  (`testing.edge_pairs`: 0, 1, 2, p - 1, p - 2, R mod p, p >> 1) planted,
  against the JAX DeviceField and Python integers;
- a toy MiMC proof against the pin of the JAX package's bytes
  (genstark_tpu_torch.testing), which `slow` tests recompute, and the
  mimc192-2^18 pin of the port's own plain versions (`slow`)."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genstark_tpu import ntt as jax_ntt
from genstark_tpu.field import create_prime_field as jax_field
from genstark_tpu_torch import kernels, ntt
from genstark_tpu_torch.field import create_prime_field
from genstark_tpu_torch.field.limbs import ints_to_limbs, limbs_to_ints
from genstark_tpu_torch.ntt import DftPlan, Radix2Plan, dft, radix2, transform
from genstark_tpu_torch.testing import (LARGE_STEPS, MIMC192_18_PIN, SOLINAS96, SOLINAS96_64_PIN,
                                        SOLINAS160, SOLINAS160_64_PIN, SOLINAS192,
                                        SOLINAS192_64_PIN, edge_pairs)

MID = pytest.mark.parametrize("modulus", [SOLINAS96, SOLINAS160, SOLINAS192],
                              ids=["p96", "p160", "p192"])
PINS = {SOLINAS96: SOLINAS96_64_PIN, SOLINAS160: SOLINAS160_64_PIN,
        SOLINAS192: SOLINAS192_64_PIN}
TOY = {"hash_algorithm": "blake2s256", "extension_factor": 4, "exe_query_count": 8,
       "fri_query_count": 6}


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _values(modulus, n, seed):
    """n canonical field values: every ordered edge pair first (xs, ys), then
    random ones."""
    field = create_prime_field(modulus)
    xs, ys = edge_pairs(field)
    rng = np.random.default_rng(seed)
    rand = lambda: int.from_bytes(rng.bytes(field.params.L * 2 + 8), "little") % modulus
    extra = n - len(xs)
    return xs + [rand() for _ in range(extra)], ys + [rand() for _ in range(extra)]


def _digest(data: bytes):
    return len(data), hashlib.sha256(data).hexdigest()


@MID
def test_limb_counts_and_route(modulus):
    """The field's L is 6, 10 or 12, the spec counts the same limbs, and
    both the digit route and the field kernels are built for it."""
    field = create_prime_field(modulus)
    L = field.params.L
    assert L == {96: 6, 160: 10, 192: 12}[modulus.bit_length()]
    assert dft.solinas_spec(modulus)[:2] == (L, 2 * L + 1)
    assert L in kernels.FIELD_LS and L in kernels.DFT_LS and ntt.digit_dft_field(field)
    assert dft.max_m(L) == 2048
    # one k step of 32 a slice where two would not fit the fragment budget
    assert kernels.dft_slice(L) == (64 if L == 6 else 32)


@MID
def test_digit_transform_matches_radix2_and_jax(modulus):
    """A 2^10-point transform in two DFT levels of 32, forward (scale 1)
    and inverse (n^-1 folded into level 1's digits), against the radix-2
    route's plain transform on plans of the same root and scale and
    against the JAX package's ntt and intt."""
    n = 1 << 10
    field = create_prime_field(modulus)
    dev = field.device_field("cpu")
    L = field.params.L
    xs, ys = _values(modulus, n, modulus % 977)
    x = np.stack([ints_to_limbs(xs, L), ints_to_limbs(ys, L)])            # [2, L, n]
    xt = dev.from_numpy(x)
    root = field.get_root_of_unity(n)
    got = {}
    for name, r, scale in (("fwd", root, 1), ("inv", field.inv(root), field.inv(n))):
        plan = ntt.make_plan(field, dev, n, r, scale)
        assert isinstance(plan, DftPlan) and plan.levels == (32, 32)
        got[name] = transform(dev, xt, plan)
        want = radix2.transform_ref(dev, xt, Radix2Plan(field, dev, n, r, scale))
        assert torch.equal(got[name], want), name
    jf = jax_field(modulus)
    assert np.array_equal(dev.to_numpy(got["fwd"]), np.asarray(jax_ntt.ntt(jf, jnp.asarray(x))))
    assert np.array_equal(dev.to_numpy(got["inv"]), np.asarray(jax_ntt.intt(jf, jnp.asarray(x))))


@MID
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_field_ops_with_edges(modulus, op):
    """Kernel 5's plain version, and the public op on CPU tensors, over
    every ordered edge pair and random values: equal to the JAX
    DeviceField and to Python integers."""
    field = create_prime_field(modulus)
    dev = field.device_field("cpu")
    L, p, R = field.params.L, modulus, field.params.R
    xs, ys = _values(modulus, 64, modulus % 991 + len(op))
    a, b = ints_to_limbs(xs, L), ints_to_limbs(ys, L)
    plain = {"mul": dev.mont_mul_ref, "add": dev.add_ref, "sub": dev.sub_ref}[op]
    public = {"mul": dev.mont_mul, "add": dev._add, "sub": dev._sub}[op]
    got = plain(dev.from_numpy(a), dev.from_numpy(b))
    assert torch.equal(public(dev.from_numpy(a), dev.from_numpy(b)), got)
    jdev = jax_field(modulus).device
    want = {"mul": jdev.mul, "add": jdev.add, "sub": jdev.sub}[op](jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want).astype(np.uint32))
    ref = {"mul": lambda x, y: x * y * pow(R, -1, p) % p, "add": lambda x, y: (x + y) % p,
           "sub": lambda x, y: (x - y) % p}[op]
    assert limbs_to_ints(got.numpy().astype(np.uint32)) == [ref(x, y) for x, y in zip(xs, ys)]


@MID
def test_outer_table_with_edges(modulus):
    """Kernel 6's plain version: outer[j, s] = a_j b_s (Montgomery) over the
    edge values on both sides, against the JAX DeviceField and integers."""
    field = create_prime_field(modulus)
    dev = field.device_field("cpu")
    L, p, R = field.params.L, modulus, field.params.R
    xs, _ = _values(modulus, 49, 7)
    outer, inner = xs[::7][:7], xs[:16]
    a, b = ints_to_limbs(outer, L), ints_to_limbs(inner, L)
    got = dev.outer_table_ref(dev.from_numpy(a), dev.from_numpy(b))
    assert torch.equal(dev.outer_table(dev.from_numpy(a), dev.from_numpy(b)), got)
    want = jax_field(modulus).device.outer_table(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want).astype(np.uint32))
    R_inv = pow(R, -1, p)
    assert limbs_to_ints(got.numpy().astype(np.uint32)) == [
        x * y * R_inv % p for x in outer for y in inner]


@MID
def test_inverse_with_edges(modulus):
    """Kernel A's plain version (mont_pow_ref(x, p - 2)) and the batched
    inverse (inv, 0 -> 0) over the edge values and random ones, against
    pow."""
    field = create_prime_field(modulus)
    dev = field.device_field("cpu")
    p = modulus
    xs, _ = _values(modulus, 56, 11)
    values = sorted(set(xs[:49:7]) | set(xs[49:]))
    x = dev.from_ints(values)
    want = [pow(v, p - 2, p) for v in values]
    assert dev.to_ints(dev.mont_pow_ref(x, p - 2)) == want
    assert dev.to_ints(dev.mont_inv(x)) == want
    assert dev.to_ints(dev.inv(x)) == want == dev.to_ints(dev.inv_ref(x))


@MID
def test_toy_pin(modulus):
    """MiMC, 64 steps, 64 constants, the toy options with blake2s256,
    secret input 3: the port's proof on the CPU (the digit route at L = 6,
    10, 12) equals the JAX package's bytes, and the port verifies it."""
    from examples.mimc_torch import make_mimc_stark, run_mimc
    from genstark_tpu_torch.protocol import Assertion
    stark, constants = make_mimc_stark(64, "cpu", modulus=modulus, options=TOY)
    controls = run_mimc(stark.air.field, 64, constants, 3)
    assertions = [Assertion(0, 0, controls[0]), Assertion(63, 0, controls[-1])]
    data = stark.serialize(stark.prove(assertions, [[3]]))
    assert _digest(data) == PINS[modulus]
    assert stark.verify(assertions, stark.parse(data))


@pytest.mark.slow
@MID
def test_toy_pin_from_jax(modulus):
    """Recompute each toy pin with the JAX package (60-130 s of XLA:CPU) and
    verify the port's bytes with the JAX verifier."""
    from examples.mimc import make_mimc_stark, run_mimc
    from examples.mimc_torch import prove_mimc
    from genstark_tpu.protocol import Assertion
    jstark, constants = make_mimc_stark(64, modulus, use_input=True, options=TOY)
    controls = run_mimc(jstark.air.field, 64, constants, 3)
    assertions = [Assertion(0, 0, controls[0]), Assertion(63, 0, controls[-1])]
    assert _digest(jstark.serialize(jstark.prove(assertions, [[3]]))) == PINS[modulus]
    _, data = prove_mimc(64, "cpu", modulus=modulus, options=TOY)
    assert jstark.verify(assertions, jstark.parse(data))


def test_cli_takes_a_modulus_expression():
    """examples/mimc_torch.py's command line takes a field name or an
    integer expression (`^` for `**`), and nothing else."""
    from examples.mimc_torch import parse_modulus
    from genstark_tpu_torch.field import P256
    assert parse_modulus("2^192 - 49*2^32 + 1") == SOLINAS192
    assert parse_modulus("(2**96) - 2**32 + 1") == SOLINAS96
    assert parse_modulus("p256") == P256
    for bad in ("__import__('os')", "2 / 3", "P999", "x + 1"):
        with pytest.raises(ValueError):
            parse_modulus(bad)


@pytest.mark.slow
def test_mimc192_2_18_pin():
    """Recompute the mimc192-2^18 pin (MiMC over 2^192 - 49 2^32 +
    1, 2^18 steps, the bench options: Ne = 2^22 on the digit route) with the
    port's plain versions on the CPU (`python -m examples.mimc_torch 262144
    cpu '2^192 - 49*2^32 + 1'`)."""
    from examples.mimc_torch import prove_mimc
    _, data = prove_mimc(LARGE_STEPS, "cpu", modulus=SOLINAS192)
    assert _digest(data) == MIMC192_18_PIN
