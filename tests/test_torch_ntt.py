"""The port's DFT level (plain version of kernel 1) and multi-level
transform against the JAX package, exactly (tolerance 0).  The level tests
run at every limb count kernel 1 is built for: p32, 2^64 - 2^32 + 1, p128,
p224 and p256, the fields the JAX package's `solinas_spec` takes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genstark_tpu import ntt as jax_ntt
from genstark_tpu.field import create_prime_field as jax_field
from genstark_tpu.ntt.mxu import _run_dft_level_ref
from genstark_tpu_torch import kernels
from genstark_tpu_torch.field import P32, P128, P224, P256, create_prime_field
from genstark_tpu_torch.ntt import DftPlan, dft, dft_levels, transform
from genstark_tpu_torch.testing import GOLDILOCKS

FIELDS = pytest.mark.parametrize("modulus", [P32, P128], ids=["p32", "p128"])
LEVEL_FIELDS = pytest.mark.parametrize("modulus", [P32, GOLDILOCKS, P128, P224, P256],
                                       ids=["p32", "goldilocks", "p128", "p224", "p256"])


def _elements(rng, modulus, n):
    L = create_prime_field(modulus).params.L
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, modulus >> (16 * (L - 1)), size=n)
    return limbs.astype(np.uint32)


def _level_inputs(modulus, m, rest, mode, seed):
    """w8, x8 and twiddle tables (numpy) for one level of size m."""
    field = create_prime_field(modulus)
    rng = np.random.default_rng(seed)
    L = field.params.L
    cols = 4 * rest
    root = field.get_root_of_unity(m * rest)
    w8 = dft.w_digits(field, m, pow(root, rest, modulus), 1)
    dev = field.device_field("cpu")
    x = dev.from_numpy(_elements(rng, modulus, m * cols)).reshape(L, m, cols)
    x8 = dft.encode_digits(x).numpy()
    if mode == "none":
        tw = None
    elif mode == "direct":
        tw = {"p": dft._direct_panel_np(field.params, root, m, rest, 2 * rest)}
    else:
        s = 4
        tw = {"a": np.transpose(dft._panel_grid_np(field.params, pow(root, s, modulus),
                                                   m, rest // s), (2, 0, 1)).copy(),
              "b": dft._panel_grid_np(field.params, root, m, s)}
    return field, dev, w8, x8, tw


@LEVEL_FIELDS
@pytest.mark.parametrize("mode,rest", [("none", 1), ("direct", 4), ("factored", 16)])
@pytest.mark.parametrize("out_digits", [False, True], ids=["limbs", "digits"])
def test_dft_level_matches_jax(modulus, mode, rest, out_digits):
    m = 8
    field, dev, w8, x8, tw = _level_inputs(modulus, m, rest, mode, seed=rest)
    to_t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(
        np.int8 if a.dtype == np.int8 else np.int32))
    tw_t = None if tw is None else {k: to_t(v) for k, v in tw.items()}
    got = dft.run_dft_level(dev, to_t(w8), to_t(x8), m, rest, tw_t, out_digits)
    tw_j = None if tw is None else {k: jnp.asarray(v) for k, v in tw.items()}
    want = _run_dft_level_ref(jax_field(modulus), jnp.asarray(w8), jnp.asarray(x8),
                              m, rest, tw_j, out_digits)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy().astype(want.dtype), want)


@LEVEL_FIELDS
@pytest.mark.parametrize("mode,rest", [("none", 1), ("direct", 4), ("factored", 16)])
def test_dft_level_limbs_in_equals_digits_in(modulus, mode, rest):
    """The level's limbs-in mode (the transform's first level, whose digits
    kernel 1 encodes as it loads) equals the digits-in level on
    `encode_digits` of the same limbs and the JAX package's level; so do
    both inputs as the transform's strided view [planes, pre, m, r]."""
    m, pre = 8, 2
    field, dev, w8, x8, tw = _level_inputs(modulus, m, rest, mode, seed=rest)
    L, cols = field.params.L, x8.shape[2]
    x = torch.from_numpy(_elements(np.random.default_rng(rest), modulus, m * cols)
                         .astype(np.int32)).reshape(L, m, cols)
    to_t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(
        np.int8 if a.dtype == np.int8 else np.int32))
    tw_t = None if tw is None else {k: to_t(v) for k, v in tw.items()}
    digits = dft.encode_digits(x)
    assert np.array_equal(digits.numpy(), x8)
    want = dft.run_dft_level(dev, to_t(w8), digits, m, rest, tw_t)
    tw_j = None if tw is None else {k: jnp.asarray(v) for k, v in tw.items()}
    jax_want = _run_dft_level_ref(jax_field(modulus), jnp.asarray(w8), jnp.asarray(x8),
                                  m, rest, tw_j, False)
    assert np.array_equal(want.numpy().astype(np.uint32), np.asarray(jax_want))
    view = lambda t: t.reshape(t.shape[0], m, pre, cols // pre).permute(0, 2, 1, 3)
    for given in (x, view(x), view(x).contiguous(), view(digits)):
        assert torch.equal(dft.run_dft_level(dev, to_t(w8), given, m, rest, tw_t), want)


@FIELDS
@pytest.mark.parametrize("bits", range(4, 11))
def test_transform_matches_jax_ntt(modulus, bits):
    """Forward transform (scale 1) and the inverse with n^-1 folded into the
    level-1 digits, against the JAX ntt / intt on the same limbs."""
    n = 1 << bits
    field = create_prime_field(modulus)
    jf = jax_field(modulus)
    dev = field.device_field("cpu")
    rng = np.random.default_rng(bits)
    x = _elements(rng, modulus, 2 * n).reshape(field.params.L, 2, n).transpose(1, 0, 2).copy()
    root = field.get_root_of_unity(n)
    fwd = transform(dev, dev.from_numpy(x), DftPlan(field, dev, n, root, 1))
    inv = transform(dev, dev.from_numpy(x),
                    DftPlan(field, dev, n, field.inv(root), field.inv(n)))
    xj = jnp.asarray(x)
    assert np.array_equal(dev.to_numpy(fwd), np.asarray(jax_ntt.ntt(jf, xj)))
    assert np.array_equal(dev.to_numpy(inv), np.asarray(jax_ntt.intt(jf, xj)))


@FIELDS
def test_lde_with_folded_r_inverse(modulus):
    """The standard-form LDE: R^-1 folded into level 1 equals LDE then
    from-Montgomery (the JAX package's non-MXU path)."""
    n, T = 1 << 8, 1 << 5
    field = create_prime_field(modulus)
    jf = jax_field(modulus)
    dev = field.device_field("cpu")
    coeffs = _elements(np.random.default_rng(3), modulus, T)
    padded = np.pad(coeffs, ((0, 0), (0, n - T)))
    plan = DftPlan(field, dev, n, field.get_root_of_unity(n),
                   field.inv(field.params.R_mod % modulus))
    got = transform(dev, dev.from_numpy(padded), plan)
    want = jf.device.from_mont(jax_ntt.low_degree_extend(jf, jnp.asarray(coeffs), n))
    assert np.array_equal(dev.to_numpy(got), np.asarray(want))


def test_level_split():
    assert dft_levels(16) == (16,)
    assert dft_levels(64) == (64,)
    assert dft_levels(128) == (16, 8)
    assert dft_levels(2 ** 17) == (64, 64, 32)
    for bits in range(1, 22):
        levels = dft_levels(1 << bits)
        assert int(np.prod(levels)) == 1 << bits
        assert max(levels) <= 64 and len(levels) == max(1, -(-bits // 6))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel entry takes CUDA tensors only: nothing falls back."""
    _, dev, w8, x8, _ = _level_inputs(P128, 8, 1, "none", seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dft_level(dev, torch.from_numpy(w8), torch.from_numpy(x8), 8, 1, None, False)
