"""The port's ceiling probes (genstark_tpu_torch/roofline.py, kernels 10 and
11) against the JAX package's probe kernels, exactly: `_mont_chain_kernel`
of scripts/roofline.py and `_kernel` of scripts/vpu_bound.py, both run in
Pallas interpret mode on the CPU.  The scripts are loaded by file path."""

import importlib.util
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genstark_tpu.field import create_prime_field as jax_field
from genstark_tpu_torch import roofline
from genstark_tpu_torch.field import P32, P64, P128, P224, P256, create_prime_field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _elements(rng, modulus, L, n):
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, modulus >> (16 * (L - 1)), size=n)
    return limbs.astype(np.uint32)


def test_mont_chain_ref_matches_roofline_kernel():
    """Kernel 10: depth 2 at P64 over 2048 elements (one block)."""
    script = _load_script("roofline")
    x = _elements(np.random.default_rng(10), P64, 4, 2048)
    want = script._mont_chain_kernel(jax_field(P64), 2, 2048)(jnp.asarray(x))
    dev = create_prime_field(P64).device_field("cpu")
    got = roofline.mont_chain(dev, dev.from_numpy(x), 2)
    assert np.array_equal(dev.to_numpy(got), np.asarray(want))


def test_u32_chain_ref_matches_vpu_bound_kernel():
    """Kernel 11: the 512-op chain on (8, 2048) words."""
    from jax.experimental import pallas as pl
    script = _load_script("vpu_bound")
    shape = (8, 2048)
    x = np.random.default_rng(11).integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    call = pl.pallas_call(partial(script._kernel, mix=0),
                          out_shape=jax.ShapeDtypeStruct(shape, jnp.uint32),
                          in_specs=[pl.BlockSpec(shape, lambda i: (0, 0))],
                          out_specs=pl.BlockSpec(shape, lambda i: (0, 0)),
                          grid=(1,), interpret=True)
    want = np.asarray(call(jnp.asarray(x)))
    got = roofline.u32_chain(torch.from_numpy(x.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert roofline.U32_OPS_PER_ELEMENT == (script.K // 4) * 5


@pytest.mark.parametrize("modulus", [P64, P256], ids=["p64", "p256"])
def test_mont_chain_is_repeated_squaring(modulus):
    """The chain is x^(2^depth) times R^(1 - 2^depth): checked on host ints
    through the Montgomery form, depth 0 returns its input."""
    field = create_prime_field(modulus)
    dev = field.device_field("cpu")
    vals = [3, 5, modulus - 1, 123456789]
    x = dev.from_ints(vals)
    assert torch.equal(roofline.mont_chain(dev, x, 0), x)
    got = dev.to_ints(roofline.mont_chain(dev, x, 3))
    assert got == [pow(v, 8, modulus) for v in vals]


@pytest.mark.parametrize("modulus", [P32, P64, P128, P224, P256],
                         ids=["p32", "p64", "p128", "p224", "p256"])
def test_mont_min_u32_ops_is_a_cios_schedule(modulus):
    """The multiply count of the Montgomery bound is met by a word-serial
    CIOS product on 32-bit words (a low and a high half per word product,
    a low half for each quotient), which equals the port's mont_mul."""
    field = create_prime_field(modulus)
    dev = field.device_field("cpu")
    L = dev.L
    k, mask = (L + 1) // 2, (1 << 32) - 1
    words = lambda v: [(v >> (32 * i)) & mask for i in range(k)]
    n0 = (-pow(modulus, -1, 1 << 32)) & mask
    rng = np.random.default_rng(L)
    vals = [int.from_bytes(rng.bytes(32), "little") % modulus for _ in range(8)]
    raw = lambda xs: dev.from_ints(xs, to_mont=False)
    want = dev.to_ints(dev.mont_mul(raw(vals), raw(vals[::-1])), from_mont=False)
    for a, b, w in zip(vals, vals[::-1], want):
        muls, t, pw = 0, 0, words(modulus)
        for bi in words(b):
            t += sum(aj * bi << (32 * j) for j, aj in enumerate(words(a)))
            m = (t & mask) * n0 & mask
            t += sum(m * pj << (32 * j) for j, pj in enumerate(pw))
            t >>= 32
            muls += 4 * k + 1
        assert (t - modulus if t >= modulus else t) == w
        assert muls == roofline.mont_min_u32_ops(L)


def test_rates_need_a_card():
    dev = create_prime_field(P64).device_field("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.mont_rate(dev, n=2048)
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.u32_rate("cpu", n=256)
