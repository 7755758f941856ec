"""The transform route per modulus (`ntt.make_plan`, `ntt.digit_dft_field`).

`dft.solinas_spec` counts a modulus's limbs from its bytes, the field from
its 32-bit words, so the two differ for a byte count of 2 mod 4.  Such a
modulus must take the radix-2 route: on the digit route its digit planes
would miss the field's top limb (the plain level raised `IndexError`).  The
port's `ntt` / `intt` over each are held to the JAX package's default route
(XLA on the CPU) on the same numpy inputs, tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genstark_tpu import ntt as jax_ntt
from genstark_tpu.field import create_prime_field as jax_field
from genstark_tpu_torch import ntt
from genstark_tpu_torch.field import P32, P64, P128, P224, P256, create_prime_field
from genstark_tpu_torch.ntt import DftPlan, Radix2Plan, dft
from genstark_tpu_torch.testing import (GOLDILOCKS, SOLINAS96, SOLINAS160, SOLINAS192, SPLIT80,
                                        SPLIT144, SPLIT176)

# (modulus, points): spec L one less than the field's L
MISMATCHED = [(12289, 64), (0xFFFFFFFA0001, 1024), (2 ** 112 - 24 * 2 ** 32 + 1, 1024),
              (SPLIT80, 1024), (SPLIT144, 1024), (SPLIT176, 1024)]
MISMATCHED_IDS = ["p14", "p48", "p112", "p80", "p144", "p176"]


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _batch(modulus, B, n, seed):
    """u32 [B, L, n] canonical limbs, the first values 0, 1, p - 1."""
    L = create_prime_field(modulus).params.L
    rng = np.random.default_rng(seed)
    vals = [int(v) for v in rng.integers(0, 1 << 62, size=B * n)]
    vals = [(v * (1 << 130) + v * v) % modulus for v in vals]
    vals[:3] = [0, 1, modulus - 1]
    limbs = np.array([[(v >> (16 * t)) & 0xFFFF for v in vals] for t in range(L)],
                     dtype=np.uint32)
    return limbs.reshape(L, B, n).transpose(1, 0, 2).copy()


@pytest.mark.parametrize("modulus,n", MISMATCHED, ids=MISMATCHED_IDS)
def test_mismatched_limb_counts_take_radix2(modulus, n):
    """make_plan gives the radix-2 plan, and the port's ntt / intt on the
    CPU equal the JAX package's default ntt / intt bit for bit."""
    field = create_prime_field(modulus)
    spec = dft.solinas_spec(modulus)
    assert spec is not None and spec[0] == field.params.L - 1
    assert not ntt.digit_dft_field(field)
    dev = field.device_field("cpu")
    root = field.get_root_of_unity(n)
    for r, scale in ((root, 1), (field.inv(root), field.inv(n))):
        assert isinstance(ntt.make_plan(field, dev, n, r, scale), Radix2Plan)
    x = _batch(modulus, 2, n, n + modulus % 1000)
    xt = dev.from_numpy(x)
    fwd, inv = ntt.ntt(field, xt), ntt.intt(field, xt)
    jf = jax_field(modulus)
    assert np.array_equal(dev.to_numpy(fwd), np.asarray(jax_ntt.ntt(jf, jnp.asarray(x))))
    assert np.array_equal(dev.to_numpy(inv), np.asarray(jax_ntt.intt(jf, jnp.asarray(x))))
    assert torch.equal(ntt.intt(field, fwd), xt)


@pytest.mark.parametrize("modulus,digit", [
    (P32, True), (GOLDILOCKS, True), (P128, True), (P224, True), (P256, True),
    (SOLINAS96, True), (SOLINAS160, True), (SOLINAS192, True),
    (P64, False), (96769, False), (2 ** 96 - 65683 * 2 ** 32 + 1, False)],
    ids=["p32", "goldilocks", "p128", "p224", "p256", "p96", "p160", "p192", "p64", "demo",
         "p96-wide-u"])
def test_route_per_modulus(modulus, digit):
    """Every modulus whose spec counts the field's limbs takes the digit
    route; a modulus the spec refuses takes the radix-2 route."""
    field = create_prime_field(modulus)
    dev = field.device_field("cpu")
    assert ntt.digit_dft_field(field) is digit
    plan = ntt.make_plan(field, dev, 256, field.get_root_of_unity(256))
    assert isinstance(plan, DftPlan if digit else Radix2Plan)
