"""The port's torch DeviceField against the JAX DeviceField: the same numpy
limbs through both, compared exactly (tolerance 0: integer field math)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genstark_tpu.field import create_prime_field as jax_field
from genstark_tpu_torch.field import P32, P128, create_prime_field

N = 64


def _elements(rng, modulus, n):
    """u32 [L, n] canonical limbs (random limbs, top limb below p's)."""
    L = create_prime_field(modulus).params.L
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, modulus >> (16 * (L - 1)), size=n)
    return limbs.astype(np.uint32)


def _pair(modulus):
    return create_prime_field(modulus).device_field("cpu"), jax_field(modulus).device


def _same(port_out: torch.Tensor, jax_out) -> None:
    got = port_out.numpy().astype(np.uint32)
    want = np.asarray(jax_out).astype(np.uint32)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


OPS = {
    "mont_mul": (lambda d, a, b: d.mont_mul(a, b), lambda j, a, b: j.mul(a, b)),
    "add": (lambda d, a, b: d._add(a, b), lambda j, a, b: j.add(a, b)),
    "sub": (lambda d, a, b: d._sub(a, b), lambda j, a, b: j.sub(a, b)),
    "neg": (lambda d, a, b: d._neg(a), lambda j, a, b: j.neg(a)),
    "sqr": (lambda d, a, b: d._sqr(a), lambda j, a, b: j.sqr(a)),
    "to_mont": (lambda d, a, b: d._to_mont(a), lambda j, a, b: j.to_mont(a)),
    "from_mont": (lambda d, a, b: d._from_mont(a), lambda j, a, b: j.from_mont(a)),
    "exp3": (lambda d, a, b: d._exp_static(a, 3), lambda j, a, b: j.exp_static(a, 3)),
    "mul_broadcast": (lambda d, a, b: d.mont_mul(a, b[:, :1]),
                      lambda j, a, b: j.mul(a, b[:, :1])),
}


@pytest.mark.parametrize("modulus", [P32, P128], ids=["p32", "p128"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_field_op_matches_jax(modulus, op):
    rng = np.random.default_rng(sorted(OPS).index(op))
    a, b = _elements(rng, modulus, N), _elements(rng, modulus, N)
    dev, jdev = _pair(modulus)
    port_fn, jax_fn = OPS[op]
    _same(port_fn(dev, dev.from_numpy(a), dev.from_numpy(b)),
          jax_fn(jdev, jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("modulus", [P32, P128], ids=["p32", "p128"])
def test_combine_many_mont_matches_jax(modulus):
    rng = np.random.default_rng(7)
    vecs = [_elements(rng, modulus, N) for _ in range(3)]
    coeffs = _elements(rng, modulus, 3)
    dev, jdev = _pair(modulus)
    got = dev.combine_many_mont([dev.from_numpy(v) for v in vecs], dev.from_numpy(coeffs))
    want = jax.jit(lambda v, c: jdev.combine_many_mont([v[0], v[1], v[2]], c))(
        jnp.asarray(np.stack(vecs)), jnp.asarray(coeffs))
    _same(got, want)


@pytest.mark.parametrize("modulus", [P32, P128], ids=["p32", "p128"])
def test_ints_and_consts_match_jax(modulus):
    rng = np.random.default_rng(11)
    values = [int(v) % modulus for v in rng.integers(0, 2**62, size=16)] + [0, 1, modulus - 1]
    dev, jdev = _pair(modulus)
    _same(dev.from_ints(values), jdev.from_ints(values))
    assert dev.to_ints(dev.from_ints(values)) == values
    _same(dev.const(values[0], shape=(1,)), jdev.const(values[0], shape=(1,)))
    arr = _elements(rng, modulus, 8)
    assert np.array_equal(dev.to_numpy(dev.from_numpy(arr)), arr)
    assert dev.from_numpy(arr).dtype == torch.int32
