"""The digit route at the MiMC-128 ladder's shapes (2^17, 2^20 and 2^21
steps: Ne = 2^21, 2^24 and 2^25), at toy size on the CPU.

A transform of Ne = 2^25 points runs five DFT levels of 32 and one of 2^24
four levels of 64.  Lowering `ntt.MAX_LEVEL_BITS` to 2 splits a 2^10-point
transform into five levels of 4 (and its 16x LDE into seven), with
factored twiddles wherever rest > 4, so the chain of digit planes between
five and more levels runs here through the port's plain versions, against
the JAX package's `ntt` on the same numpy inputs (tolerance 0)."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genstark_tpu import ntt as jax_ntt
from genstark_tpu.field import create_prime_field as jax_field
from genstark_tpu_torch import ntt, testing
from genstark_tpu_torch.field import P128, create_prime_field
from genstark_tpu_torch.ntt import DftPlan, dft, dft_levels, table_specs

N = 2 ** 10
EXT = 16


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def two_bit_levels(monkeypatch):
    """Levels of at most 4 points; the level split's cache and the public
    ntt's plans (kept by the p128 DeviceField) are fresh inside the test
    and dropped after it."""
    monkeypatch.setattr(ntt, "MAX_LEVEL_BITS", 2)
    dft_levels.cache_clear()
    field = create_prime_field(P128)
    dev = field.device_field("cpu")
    monkeypatch.setattr(dev, "plans", {})
    yield field, dev
    dft_levels.cache_clear()


def _elements(seed, n):
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(8, n), dtype=np.int64)
    limbs[7] = rng.integers(0, P128 >> 112, size=n)
    return limbs.astype(np.uint32)


@pytest.mark.parametrize("op", ["ntt", "intt", "lde"])
def test_five_level_chain_matches_jax(two_bit_levels, op):
    """ntt and intt of 2^10 p128 points in five 4-point levels, and the 16x
    LDE to 2^14 in seven, through the port's plain versions, equal the JAX
    package's ntt, intt and low_degree_extend."""
    field, dev = two_bit_levels
    x = _elements(1013, N)
    jf = jax_field(P128)
    xj = jnp.asarray(x)
    if op == "lde":
        got = ntt.low_degree_extend(field, dev.from_numpy(x), EXT * N)
        want = jax_ntt.low_degree_extend(jf, xj, EXT * N)
        n = EXT * N
    else:
        got = getattr(ntt, op)(field, dev.from_numpy(x))
        want = getattr(jax_ntt, op)(jf, xj)
        n = N
    plan = dev.plans[(n, op == "intt")]
    assert plan.levels == (4,) * {N: 5, EXT * N: 7}[n]
    assert any(tw is not None and "a" in tw for tw in plan.tws), "no factored twiddle"
    assert np.array_equal(dev.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("bits,count,size", [(21, 4, (64, 32, 32, 32)), (24, 4, (64,) * 4),
                                             (25, 5, (32,) * 5)])
def test_ladder_host_recipe(bits, count, size):
    """The level split and the twiddle recipe at the ladder's real sizes:
    the levels multiply to n, each factored twiddle's s divides its rest,
    and Ne = 2^25 takes five levels of 32."""
    field = create_prime_field(P128)
    n = 1 << bits
    levels = dft_levels(n)
    assert levels == size and len(levels) == count
    assert int(np.prod(levels)) == n
    w8_roots, tws = table_specs(field, n, field.get_root_of_unity(n),
                                field.inv(field.params.R_mod % P128))
    assert len(w8_roots) == len(tws) == count
    rest = n
    for m, spec in zip(levels, tws):
        rest //= m
        if rest == 1:
            assert spec is None
        elif spec[0] == "d":
            assert spec[2] == rest <= 64
        else:
            _, _, outer, _, s = spec
            assert rest // s * s == rest and outer * s == rest and outer <= s


@pytest.mark.parametrize("mode", ["factored", "direct", "none"])
def test_plain_level_chunks_equal_the_whole_level(monkeypatch, mode):
    """testing.plain_level (the plain DFT level in column chunks, which
    chip_smoke.py holds kernel 1 against at 2^24 and 2^25 points) equals the
    whole plain level, limbs in as the transform's strided view and digits
    in, chunks narrower than rest included."""
    field = create_prime_field(P128)
    dev = field.device_field("cpu")
    n = 2 ** 13                                       # levels (32, 16, 16)
    plan = DftPlan(field, dev, n, field.get_root_of_unity(n), 7)
    lvl = {"factored": 0, "direct": 1, "none": 2}[mode]
    m = plan.levels[lvl]
    rest = n // int(np.prod(plan.levels[:lvl + 1]))
    pre = n // m // rest
    tw = plan.tws[lvl] if rest > 1 else None
    assert (tw is None) == (mode == "none") and (mode != "factored" or "a" in tw)
    x = dev.from_numpy(_elements(lvl, n))
    view = x.reshape(8, pre, m, rest)
    monkeypatch.setattr(testing, "PLAIN_LEVEL_ELEMS", 2 ** 12)    # 128 or 256 columns
    for given in (view, dft.encode_digits(view)):
        for out_digits in (False, True):
            want = dft.run_dft_level_ref(dev, plan.w8s[lvl], given, m, rest, tw, out_digits)
            got = testing.plain_level(dev, plan.w8s[lvl], given, m, rest, tw, out_digits)
            assert torch.equal(got, want)


@pytest.mark.slow
def test_ladder_17_pin():
    """Recompute the 2^17-step MiMC-128 pin (LADDER_17_PIN) with the port's plain
    versions on the CPU (about 2.5 min and 10 GiB of host memory)."""
    from examples.mimc_torch import prove_mimc
    _, data = prove_mimc(2 ** 17, "cpu")
    assert (len(data), hashlib.sha256(data).hexdigest()) == testing.LADDER_17_PIN
