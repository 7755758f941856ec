"""The port's radix-2 transform (ntt/radix2.py: the plain version of kernel
8, the four-step split, the folded scale) against the JAX package, exactly
(tolerance 0), for the fields the digit DFT does not take (P64, P224,
P256).  Inputs are numpy limbs from fixed seeds.

The four-step threshold is `radix2.LOCAL_MAX`: the tests lower it to 16
points so that both sides of it run at sizes whose JAX transforms compile
quickly, and check P64 at the real threshold."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genstark_tpu import ntt as jax_ntt
from genstark_tpu.field import create_prime_field as jax_field
from genstark_tpu.ntt import _bitrev_indices, get_plan
from genstark_tpu.ntt import pallas_kernels
from genstark_tpu_torch.field import P32, P64, P128, P224, P256, create_prime_field
from genstark_tpu_torch.ntt import DftPlan, Radix2Plan, make_plan, radix2, transform

WIDE = [P64, P224, P256]
WIDE_IDS = ["p64", "p224", "p256"]


def _elements(rng, modulus, n):
    L = create_prime_field(modulus).params.L
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, modulus >> (16 * (L - 1)), size=n)
    return limbs.astype(np.uint32)


def _batch(rng, modulus, B, n):
    """u32 [B, L, n]."""
    L = create_prime_field(modulus).params.L
    return _elements(rng, modulus, B * n).reshape(L, B, n).transpose(1, 0, 2).copy()


@pytest.fixture
def local_max(monkeypatch):
    """Set the four-step threshold for one test."""
    return lambda value: monkeypatch.setattr(radix2, "LOCAL_MAX", value)


def _check_both_directions(modulus, n):
    field = create_prime_field(modulus)
    jf = jax_field(modulus)
    dev = field.device_field("cpu")
    x = _batch(np.random.default_rng(n + modulus % 101), modulus, 2, n)
    root = field.get_root_of_unity(n)
    fwd = Radix2Plan(field, dev, n, root, 1)
    inv = Radix2Plan(field, dev, n, field.inv(root), field.inv(n))
    assert (fwd.split is None) == (n <= radix2.LOCAL_MAX)
    xj = jnp.asarray(x)
    assert np.array_equal(dev.to_numpy(transform(dev, dev.from_numpy(x), fwd)),
                          np.asarray(jax_ntt.ntt(jf, xj)))
    assert np.array_equal(dev.to_numpy(transform(dev, dev.from_numpy(x), inv)),
                          np.asarray(jax_ntt.intt(jf, xj)))


@pytest.mark.parametrize("modulus", WIDE, ids=WIDE_IDS)
@pytest.mark.parametrize("n", [16, 64], ids=["local", "four_step"])
def test_transform_matches_jax_ntt(modulus, n, local_max):
    """n = 16: one local transform (the inverse's n^-1 applied by one
    multiply); n = 64: the four-step split 8 x 8 (n^-1 folded into the
    panel), forward and inverse against JAX ntt / intt."""
    local_max(16)
    _check_both_directions(modulus, n)


@pytest.mark.parametrize("n", [256, 2048, 4096])
def test_transform_p64_larger_sizes(n, local_max):
    """P64: the four-step split at 16 x 16, and both sides of the real
    threshold (2048 points local, 4096 as 64 x 64)."""
    if n == 256:
        local_max(16)
    _check_both_directions(P64, n)


@pytest.mark.parametrize("modulus", WIDE, ids=WIDE_IDS)
def test_lde_with_folded_r_inverse(modulus, local_max):
    """The standard-form LDE of the prover (w_Ne_std): R^-1 folded into the
    four-step panel equals the JAX LDE then from-Montgomery."""
    n, T = 64, 8
    field = create_prime_field(modulus)
    jf = jax_field(modulus)
    dev = field.device_field("cpu")
    coeffs = _elements(np.random.default_rng(3), modulus, T)
    padded = np.pad(coeffs, ((0, 0), (0, n - T)))
    local_max(16)
    plan = Radix2Plan(field, dev, n, field.get_root_of_unity(n),
                      field.inv(field.params.R_mod % modulus))
    got = transform(dev, dev.from_numpy(padded), plan)
    want = jf.device.from_mont(jax_ntt.low_degree_extend(jf, jnp.asarray(coeffs), n))
    assert np.array_equal(dev.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("modulus", [P64, P128], ids=["p64", "p128"])
def test_butterfly_ref_matches_pallas_multistage(modulus):
    """The plain kernel 8 against the TPU kernel (pallas_kernels.multistage
    in interpret mode, as tests/test_pallas_ntt.py:77 runs it) on the same
    half-table: the Pallas kernel takes bit-reversed input, the port's
    butterfly bit-reverses as it loads."""
    n, B = 64, 2
    jf = jax_field(modulus)
    field = create_prime_field(modulus)
    dev = field.device_field("cpu")
    L = dev.L
    x = _batch(np.random.default_rng(17), modulus, B, n)               # [B, L, n]
    w_table = get_plan(jf, n, False).w_table                          # [L, n/2]
    x2 = jnp.take(jnp.asarray(x), _bitrev_indices(n), axis=-1).reshape(B * L, n)
    want, last_m = pallas_kernels.multistage(jf, x2, w_table, L, n, interpret=True)
    assert last_m == n // 2
    got = radix2.butterfly(dev, dev.from_numpy(x)[:, None],
                           dev.from_numpy(np.asarray(w_table)))[:, 0]
    assert np.array_equal(dev.to_numpy(got).reshape(B * L, n), np.asarray(want))


def test_plan_factory_and_split(local_max):
    """make_plan keeps the digit DFT for p32 and p128 and gives the radix-2
    plan to every other field; the split follows LOCAL_MAX, and a size the
    four-step cannot cover takes the direct route."""
    for modulus, kind in ((P32, DftPlan), (P128, DftPlan), (P64, Radix2Plan),
                          (P224, Radix2Plan), (P256, Radix2Plan)):
        field = create_prime_field(modulus)
        plan = make_plan(field, field.device_field("cpu"), 64, field.get_root_of_unity(64))
        assert isinstance(plan, kind)
    field = create_prime_field(P64)
    dev = field.device_field("cpu")
    split = lambda n: Radix2Plan(field, dev, n, field.get_root_of_unity(n)).split
    assert radix2.LOCAL_MAX == 2048
    assert split(2048) is None and split(2 ** 13) == (64, 128)
    assert split(2 ** 17) == (256, 512)
    assert radix2.DIRECT_ABOVE == 2 ** 21
    assert [radix2.route_for(n) for n in (2048, 2 ** 21, 2 ** 22)] == [
        "local", "four_step", "direct"]
    local_max(256)
    assert split(256) is None and split(512) == (16, 32) and split(2 ** 16) == (256, 256)
    plan = Radix2Plan(field, dev, 2 ** 17, field.get_root_of_unity(2 ** 17))
    assert (plan.route, plan.split) == ("direct", None)
    assert tuple(plan.twiddles.shape) == (2 ** 16, dev.L)
    assert tuple(plan.tables[0].shape) == (dev.L, 128)
    with pytest.raises(ValueError):
        Radix2Plan(field, dev, 48, 1)


def test_batched_shapes_and_plain_path(local_max):
    """A [2, 3, L, n] batch equals its rows one by one; the plain-only
    transform (transform_ref, the card's comparison path) equals the
    dispatching one."""
    field = create_prime_field(P256)
    dev = field.device_field("cpu")
    n = 32
    local_max(8)
    plan = Radix2Plan(field, dev, n, field.get_root_of_unity(n), 5)
    x = dev.from_numpy(_batch(np.random.default_rng(23), P256, 6, n)).reshape(2, 3, dev.L, n)
    got = transform(dev, x, plan)
    assert got.shape == x.shape
    rows = torch.stack([transform(dev, x[i, j], plan) for i in range(2) for j in range(3)])
    assert torch.equal(got.reshape(6, dev.L, n), rows)
    assert torch.equal(radix2.transform_ref(dev, x, plan), got)
