"""The port's device transcript (protocol/fiat_shamir.py) and the power
behind its batched inverse (`DeviceField.mont_pow_ref`, kernel A's plain
version) against the JAX package: `prng_elements_dev`, `prng_single_dev`
and the digest reduction against the JAX `fiat_shamir` functions on one
small case, the PRNG against the JAX `HostField.prng` over every field at
several counts, `mont_pow_ref` against `pow`, and `inv_ref` against the
JAX `DeviceField.inv`.  Seeds come from numpy; every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genstark_tpu.field import create_prime_field as jax_field
from genstark_tpu.field.host import HostField as JaxHostField
from genstark_tpu.protocol import fiat_shamir as jax_fs
from genstark_tpu_torch.field import P32, P64, P128, P256, create_prime_field
from genstark_tpu_torch.protocol import fiat_shamir as fs

FIELDS = [P32, P64, P128, P256]
IDS = ["p32", "p64", "p128", "p256"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _seed(rng) -> bytes:
    return rng.integers(0, 256, size=32, dtype=np.uint8).tobytes()


def _words(seed: bytes) -> np.ndarray:
    return np.frombuffer(seed, dtype="<u4").copy()


def _port_words(seed: bytes) -> torch.Tensor:
    return torch.from_numpy(_words(seed).view(np.int32).copy())


def test_prng_and_reduction_match_jax_device():
    """One p128 case through both packages' device functions: the same
    Montgomery limbs for 7 elements, one element, and a digest batch."""
    modulus = P128
    rng = np.random.default_rng(128)
    seed = _seed(rng)
    dev = create_prime_field(modulus).device_field("cpu")
    jfield = jax_field(modulus)
    got = dev.to_numpy(fs.prng_elements_dev(dev, _port_words(seed), 7))
    want = np.asarray(jax_fs.prng_elements_dev(jfield, jnp.asarray(_words(seed)), 7))
    assert np.array_equal(got, want.astype(np.uint32))
    single = dev.to_numpy(fs.prng_single_dev(dev, _port_words(seed)))
    assert np.array_equal(single, want[:, :1].astype(np.uint32))
    digests = rng.integers(0, 1 << 32, size=(8, 5), dtype=np.uint64).astype(np.uint32)
    got = dev.to_numpy(fs.digest_words_to_field_mont(
        dev, torch.from_numpy(digests.view(np.int32).copy())))
    want = np.asarray(jax_fs.digest_words_to_field_mont(jfield, jnp.asarray(digests)))
    assert np.array_equal(got, want.astype(np.uint32))


@pytest.mark.parametrize("count", [1, 7, 65])
@pytest.mark.parametrize("modulus", FIELDS, ids=IDS)
def test_prng_matches_host(modulus, count):
    """field.prng(seed, count) of the JAX host field, from the elements'
    Montgomery limbs; and the root of a flat tree is its last row."""
    dev = create_prime_field(modulus).device_field("cpu")
    rng = np.random.default_rng(modulus % 997 + count)
    for _ in range(2):
        seed = _seed(rng)
        got = dev.to_ints(fs.prng_elements_dev(dev, _port_words(seed), count))
        assert got == JaxHostField(modulus).prng(seed, count)
    flat = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(8, 7), dtype=np.int64)
                            .astype(np.int32))
    assert torch.equal(fs.root_words(flat), flat[:, 6])


@pytest.mark.parametrize("modulus", FIELDS, ids=IDS)
def test_mont_pow_ref_matches_pow(modulus):
    """a^e on Montgomery limbs: the inverse's exponent p - 2 and small
    exponents; zero, one and p - 1 among the bases."""
    field = create_prime_field(modulus)
    dev = field.device_field("cpu")
    p = field.modulus
    rng = np.random.default_rng(modulus % 1013)
    values = [int(v) % p for v in rng.integers(1, 2 ** 62, size=5)] + [0, 1, p - 1]
    x = dev.from_ints(values)
    for e in (p - 2, 1, 2, 3, 17):
        got = dev.to_ints(dev.mont_pow_ref(x, e))
        assert got == [pow(v, e, p) for v in values]
    # the public inverse takes the plain version on a CPU tensor
    assert torch.equal(dev.mont_inv(x), dev.mont_pow_ref(x, p - 2))
    with pytest.raises(ValueError):
        dev.mont_pow_ref(x, 0)


def test_inv_matches_jax():
    """`inv` (its total inverted by kernel A, here its plain version) against the
    JAX DeviceField.inv, zeros included."""
    modulus = P32
    dev = create_prime_field(modulus).device_field("cpu")
    rng = np.random.default_rng(32)
    a = rng.integers(0, 1 << 16, size=(dev.L, 40), dtype=np.int64)
    a[dev.L - 1] = rng.integers(0, modulus >> 16, size=40)
    a[:, [0, 9, 39]] = 0
    a = a.astype(np.uint32)
    got = dev.to_numpy(dev.inv(dev.from_numpy(a)))
    want = np.asarray(jax_field(modulus).device.inv(jnp.asarray(a))).astype(np.uint32)
    assert np.array_equal(got, want)
