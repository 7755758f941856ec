"""The digit route at every solinas limb count beyond p32 and p128: p224
(L = 14, D = 29), p256 (L = 16, D = 33) and 2^64 - 2^32 + 1 (L = 4, D = 9),
the fields the JAX package's `solinas_spec` takes and its `mxu_applicable`
sends through the digit DFT (genstark_tpu/ntt/__init__.py:248).

Multi-level transforms of 2^10 to 2^13 points through the port's DFT levels
(plain versions of kernel 1 on the CPU) against the radix-2 route's plain
transform (`radix2.transform_ref`) and the JAX package's `ntt` / `intt` on
the same numpy inputs (pinned as sha256 digests of the JAX outputs' limbs,
which a `slow` test remakes), tolerance 0; proofs over 2^64 - 2^32 + 1
(kernel 1 at L = 4) and over P64 at 2^18 steps (the radix-2 route's
large-domain path) against pins (genstark_tpu_torch.testing), whose `slow`
tests recompute them."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genstark_tpu import ntt as jax_ntt
from genstark_tpu.field import create_prime_field as jax_field
from genstark_tpu_torch import ntt
from genstark_tpu_torch.field import P224, P256, create_prime_field
from genstark_tpu_torch.ntt import DftPlan, Radix2Plan, dft, radix2, transform
from genstark_tpu_torch.testing import GOLDILOCKS, GOLDILOCKS_64_PIN, LARGE_STEPS, MIMC64_18_PIN

WIDE = pytest.mark.parametrize("modulus", [P224, P256], ids=["p224", "p256"])
TOY = {"hash_algorithm": "blake2s256", "extension_factor": 4, "exe_query_count": 8,
       "fri_query_count": 6}


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _batch(modulus, B, n, seed):
    """u32 [B, L, n] canonical limbs, the first three values 0, 1, p - 1."""
    L = create_prime_field(modulus).params.L
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(L, B * n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, modulus >> (16 * (L - 1)), size=B * n)
    for i, v in enumerate((0, 1, modulus - 1)):
        limbs[:, i] = [(v >> (16 * t)) & 0xFFFF for t in range(L)]
    return limbs.astype(np.uint32).reshape(L, B, n).transpose(1, 0, 2).copy()


def _digest(data: bytes):
    return len(data), hashlib.sha256(data).hexdigest()


def _limbs_digest(limbs) -> str:
    """sha256 of u32 limbs [B, L, n] as little-endian words."""
    return hashlib.sha256(np.ascontiguousarray(limbs, dtype="<u4").tobytes()).hexdigest()


# sha256 (`_limbs_digest`) of the JAX package's ntt of each case's input
# (`_batch(modulus, 2, 2^bits, bits)`), and at 2^13 of its intt too.
JAX_TRANSFORMS = {
    (P224, 10): ["acd4cb576e3de677db992a5fca1bb193a03f0e868762a1dc8dcaa5a418e5c8a8"],
    (P224, 11): ["e2d6555895a5e0b3daee8f22efdaa9c51914b428575e6e85425156b366188025"],
    (P224, 12): ["022156fe8b9782cb091ab4c0f2b78aa9c5fb03e21581d1b117d3903e0b7538de"],
    (P224, 13): ["a264dfc8e31d5282ec39eb2ee491636ef01222296aca550242ef13ccc85f51ef",
                 "83e446a282329f912b14a74722fe7a5df59fd45624b0aa77140325ca6595ae50"],
    (P256, 10): ["1812831dc5b90ab146ed34a39c500c184f74ea3f9d814cba601f5429c3589e57"],
    (P256, 11): ["df2b8cdd9ffc25a8e1256ee7b45441b2665df54339d4fc254c1763784160ca70"],
    (P256, 12): ["5ce41049bc1da240a11de60cbb02e0a8e13ae665d5a3932e71a3b031f7a74561"],
    (P256, 13): ["80e5e363cd946383c5ebce67d3020dbdc1a6f890f27a5d152dd416e6f5c28ee1",
                 "2d7ccae24bd3ac077145d6ce6b0550b590b2df0e3e22bb52dc8842326d3d34dd"],
}


@WIDE
@pytest.mark.parametrize("bits", [10, 11, 12, 13])
def test_digit_transform_matches_radix2_and_jax(modulus, bits):
    """The forward transform (scale 1) and the inverse (n^-1 folded into
    level 1's digits) through the DFT levels, against the radix-2 route's
    plain transform on plans of the same root and scale, and the forward
    one against the JAX package's ntt (its intt at 2^13): JAX_TRANSFORMS."""
    n = 1 << bits
    field = create_prime_field(modulus)
    dev = field.device_field("cpu")
    x = _batch(modulus, 2, n, bits)
    xt = dev.from_numpy(x)
    root = field.get_root_of_unity(n)
    got = {}
    for name, r, scale in (("fwd", root, 1), ("inv", field.inv(root), field.inv(n))):
        plan = ntt.make_plan(field, dev, n, r, scale)
        assert isinstance(plan, DftPlan) and len(plan.levels) == 2 + (bits > 12)
        got[name] = transform(dev, xt, plan)
        want = radix2.transform_ref(dev, xt, Radix2Plan(field, dev, n, r, scale))
        assert torch.equal(got[name], want), name
    names = ("fwd", "inv") if bits == 13 else ("fwd",)
    assert [_limbs_digest(dev.to_numpy(got[k])) for k in names] == \
        JAX_TRANSFORMS[(modulus, bits)]


@pytest.mark.slow
@WIDE
@pytest.mark.parametrize("bits", [10, 11, 12, 13])
def test_digit_transform_pin_is_the_jax_packages(modulus, bits):
    """The JAX package's ntt (and at 2^13 its intt) of each case's input
    gives JAX_TRANSFORMS (one XLA:CPU compile a size and field)."""
    jf = jax_field(modulus)
    x = jnp.asarray(_batch(modulus, 2, 1 << bits, bits))
    fns = (jax_ntt.ntt, jax_ntt.intt) if bits == 13 else (jax_ntt.ntt,)
    assert [_limbs_digest(np.asarray(fn(jf, x))) for fn in fns] == \
        JAX_TRANSFORMS[(modulus, bits)]


@pytest.mark.parametrize("modulus", [GOLDILOCKS, P224, P256],
                         ids=["goldilocks", "p224", "p256"])
def test_public_ntt_takes_the_digit_route(modulus, monkeypatch):
    """ntt / intt / low_degree_extend over the wide solinas fields run DFT
    levels only (no radix-2 transform), and equal the radix-2 route's
    plain transforms of the same plans' roots."""
    field = create_prime_field(modulus)
    dev = field.device_field("cpu")
    monkeypatch.setattr(dev, "plans", {})
    monkeypatch.setattr(radix2, "transform", None)      # any radix-2 call fails
    n = 256
    x = dev.from_numpy(_batch(modulus, 1, n, 5)[0])
    fwd = ntt.ntt(field, x)
    inv = ntt.intt(field, fwd)
    lde = ntt.low_degree_extend(field, inv, 4 * n)
    assert all(isinstance(p, DftPlan) for p in dev.plans.values()) and len(dev.plans) == 3
    assert torch.equal(inv, x) and torch.equal(lde[:, ::4], fwd)
    root = field.get_root_of_unity(n)
    assert torch.equal(fwd, radix2.transform_ref(dev, x, Radix2Plan(field, dev, n, root)))


def test_level_bound_per_limb_count():
    """The diagonal sums' 2^30 bias bounds a level at D * m * 2^14 < 2^30:
    2048 up to L = 15, 1024 at p256 (D = 33); the wrapper refuses more."""
    assert [dft.max_m(L) for L in (2, 4, 8, 14, 16)] == [2048] * 4 + [1024]
    field = create_prime_field(P256)
    with pytest.raises(ValueError, match="1024"):
        dft.w_digits(field, 2048, field.get_root_of_unity(2048))


def test_goldilocks_toy_pin():
    """MiMC over 2^64 - 2^32 + 1, 64 steps, the toy options, secret input
    3: the port's proof on the CPU (the digit route at L = 4) equals the
    JAX package's bytes."""
    from examples.mimc_torch import prove_mimc
    _, data = prove_mimc(64, "cpu", modulus=GOLDILOCKS, options=TOY)
    assert _digest(data) == GOLDILOCKS_64_PIN


@pytest.mark.slow
def test_goldilocks_toy_pin_from_jax():
    """Recompute the Goldilocks toy pin with the JAX package (about 70 s
    of XLA:CPU) and verify the port's bytes with the JAX verifier."""
    from examples.mimc import make_mimc_stark, run_mimc
    from examples.mimc_torch import prove_mimc
    from genstark_tpu.protocol import Assertion
    jstark, constants = make_mimc_stark(64, GOLDILOCKS, use_input=True, options=TOY)
    controls = run_mimc(jstark.air.field, 64, constants, 3)
    assertions = [Assertion(0, 0, controls[0]), Assertion(63, 0, controls[-1])]
    assert _digest(jstark.serialize(jstark.prove(assertions, [[3]]))) == \
        GOLDILOCKS_64_PIN
    _, data = prove_mimc(64, "cpu", modulus=GOLDILOCKS, options=TOY)
    assert jstark.verify(assertions, jstark.parse(data))


@pytest.mark.slow
def test_mimc64_2_18_pin():
    """Recompute the mimc64-2^18 pin (MiMC over P64, 2^18 steps,
    the bench options: Ne = 2^22 on the radix-2 route's direct transforms)
    with the port's plain versions on the CPU (about 3 min, 3.8 GiB)."""
    from examples.mimc_torch import prove_mimc
    from genstark_tpu_torch.field import P64
    _, data = prove_mimc(LARGE_STEPS, "cpu", modulus=P64)
    assert _digest(data) == MIMC64_18_PIN
