"""The plain versions of kernels 5 (`field_ew`: mul, add, sub) and 6
(`outer_table`) against the JAX DeviceField for every field of the port,
and against the JAX package's Pallas tile kernels in interpret mode at
p128, exactly (tolerance 0: integer field math).  Inputs are numpy limbs
from fixed seeds, the same arrays through both packages.

Also: a tensor that is not on the CPU never runs the plain versions (the
public ops hand it to the kernel wrappers, which take CUDA tensors only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genstark_tpu.field import create_prime_field as jax_field
from genstark_tpu.field import pallas_ops
from genstark_tpu_torch.field import P32, P64, P128, P224, P256, create_prime_field

FIELDS = pytest.mark.parametrize("modulus", [P32, P64, P128, P224, P256],
                                 ids=["p32", "p64", "p128", "p224", "p256"])
N = 48


def _elements(rng, modulus, n):
    """u32 [L, n] canonical limbs (random limbs, top limb below p's)."""
    L = create_prime_field(modulus).params.L
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, modulus >> (16 * (L - 1)), size=n)
    return limbs.astype(np.uint32)


def _p_minus_1(modulus, n):
    L = create_prime_field(modulus).params.L
    from genstark_tpu_torch.field.limbs import ints_to_limbs
    return ints_to_limbs([modulus - 1] * n, L)


def _same(port_out: torch.Tensor, jax_out) -> None:
    got = port_out.numpy().astype(np.uint32)
    want = np.asarray(jax_out).astype(np.uint32)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


PLAIN = {"mul": lambda d: d.mont_mul_ref, "add": lambda d: d.add_ref,
         "sub": lambda d: d.sub_ref}
PUBLIC = {"mul": lambda d: d.mont_mul, "add": lambda d: d._add, "sub": lambda d: d._sub}
JAX = {"mul": lambda j: j.mul, "add": lambda j: j.add, "sub": lambda j: j.sub}


@FIELDS
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_elementwise_plain_matches_jax(modulus, op):
    """Same-shape operands, a scalar [L, 1] on either side (sub too), and
    p - 1 in every limb position, through the plain version and through
    the public op (which on CPU tensors is the plain version)."""
    rng = np.random.default_rng(modulus % 1000 + len(op))
    a, b = _elements(rng, modulus, N), _elements(rng, modulus, N)
    c = _elements(rng, modulus, 1)
    pm1 = _p_minus_1(modulus, N)
    dev = create_prime_field(modulus).device_field("cpu")
    jfn = JAX[op](jax_field(modulus).device)
    for x, y in ((a, b), (a, c), (c, a), (pm1, pm1), (pm1, a)):
        want = jfn(jnp.asarray(x), jnp.asarray(y))
        _same(PLAIN[op](dev)(dev.from_numpy(x), dev.from_numpy(y)), want)
        _same(PUBLIC[op](dev)(dev.from_numpy(x), dev.from_numpy(y)), want)


@FIELDS
def test_outer_table_plain_matches_jax(modulus):
    rng = np.random.default_rng(modulus % 997)
    outer, inner = _elements(rng, modulus, 4), _elements(rng, modulus, 16)
    dev = create_prime_field(modulus).device_field("cpu")
    want = jax.jit(jax_field(modulus).device.outer_table)(jnp.asarray(outer), jnp.asarray(inner))
    got = dev.outer_table_ref(dev.from_numpy(outer), dev.from_numpy(inner))
    _same(got, want)
    _same(dev.outer_table(dev.from_numpy(outer), dev.from_numpy(inner)), want)


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_elementwise_plain_matches_pallas_interpret(op):
    """p128 against the TPU kernel's body (pallas_ops.elementwise in
    interpret mode, as tests/test_pallas_field_ops.py runs it): one tile
    of 2048 lanes, same-shape and [L, 1] operands, and p - 1."""
    rng = np.random.default_rng(31)
    a, b = _elements(rng, P128, 2048), _elements(rng, P128, 2048)
    c = _elements(rng, P128, 1)
    pm1 = _p_minus_1(P128, 2048)
    dev = create_prime_field(P128).device_field("cpu")
    jdev = jax_field(P128).device
    for x, y in ((a, b), (a, c), (pm1, pm1)):
        want = pallas_ops.elementwise(jdev, op, jnp.asarray(x), jnp.asarray(y), interpret=True)
        _same(PLAIN[op](dev)(dev.from_numpy(x), dev.from_numpy(y)), want)


def test_outer_table_plain_matches_pallas_interpret():
    rng = np.random.default_rng(37)
    outer, inner = _elements(rng, P128, 4), _elements(rng, P128, 256)
    dev = create_prime_field(P128).device_field("cpu")
    want = pallas_ops.outer_product_table(jax_field(P128).device, jnp.asarray(outer),
                                          jnp.asarray(inner), interpret=True)
    assert want is not None
    _same(dev.outer_table_ref(dev.from_numpy(outer), dev.from_numpy(inner)), want)


def test_strided_and_batched_operands():
    """The operand forms the prover passes: a strided column view (fri.py
    y[:, k]), a batch [L, B, N] against a broadcast constant [L, 1, 1]
    (prover._to_mont_batch), and a [L, 1] slice of a coefficient table
    (combine_many_mont), each against the same op on contiguous copies."""
    dev = create_prime_field(P256).device_field("cpu")
    rng = np.random.default_rng(41)
    y = dev.from_numpy(_elements(rng, P256, 4 * N)).reshape(dev.L, 4, N)
    x = dev.from_numpy(_elements(rng, P256, N))
    assert not y[:, 1].is_contiguous()
    assert torch.equal(dev._sub(x, y[:, 1]), dev._sub(x, y[:, 1].contiguous()))
    batch = dev.from_numpy(_elements(rng, P256, 3 * N)).reshape(dev.L, 3, N)
    r2 = dev.from_numpy(dev.params.r2_limbs).reshape(dev.L, 1, 1)
    assert torch.equal(dev.mont_mul(batch, r2),
                       torch.stack([dev.mont_mul(batch[:, k], r2[:, 0]) for k in range(3)], 1))
    coeffs = dev.from_numpy(_elements(rng, P256, 5))
    assert torch.equal(dev.mont_mul(x, coeffs[:, 2:3]), dev.mont_mul(x, coeffs[:, 2:3].clone()))


@pytest.mark.parametrize("op", ["mul", "add", "sub", "outer_table"])
def test_non_cpu_tensors_never_run_plain_torch(op):
    """A tensor on any device but the CPU goes to the kernel wrapper, which
    takes CUDA tensors only: on a 'meta' tensor the op raises instead of
    computing with plain torch."""
    dev = create_prime_field(P256).device_field("cpu")
    a = torch.empty((dev.L, 8), dtype=torch.int32, device="meta")
    fn = {"outer_table": dev.outer_table, **{k: f(dev) for k, f in PUBLIC.items()}}[op]
    with pytest.raises(ValueError, match="CUDA"):
        fn(a, a)


def test_field_kernels_refuse_unsupported_limb_counts():
    from genstark_tpu_torch import kernels
    dev = create_prime_field(2 ** 61 - 1).device_field("cpu")    # L = 4 is taken
    assert dev.L == 4
    assert create_prime_field(2 ** 89 - 1).params.L in kernels.FIELD_LS   # so is L = 6
    odd = create_prime_field(2 ** 521 - 1).device_field("cpu")   # L = 34 is not
    assert odd.L == 34
    x = torch.zeros((odd.L, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="L in"):
        kernels.field_ew(odd, "mul", x, x)
