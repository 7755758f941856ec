"""The fused stage passes of the port's direct radix-2 route (kernels 7 and
9: `radix2.butterfly_stages_ref`, k consecutive stages in one pass, on the
element-major stage table) against the JAX package, exactly (tolerance 0).
Inputs are numpy limbs from fixed seeds; the JAX Pallas stage kernels run
in interpret mode, as tests/test_pallas_ntt.py runs them."""

import jax.numpy as jnp
import numpy as np
import pytest

from genstark_tpu import ntt as jax_ntt
from genstark_tpu.field import create_prime_field as jax_field
from genstark_tpu.ntt import pallas_kernels as pk
from genstark_tpu_torch.field import P64, P256, create_prime_field
from genstark_tpu_torch.field.limbs import power_series_mont_np
from genstark_tpu_torch.ntt import Radix2Plan, radix2, transform


def _elements(rng, modulus, L, n):
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, modulus >> (16 * (L - 1)), size=n)
    return limbs.astype(np.uint32)


def _jax_stages(modulus, x, table, n, m, k):
    """k successive stages of the JAX package's stage dispatch
    (`butterfly_stage2`: the whole-group kernel `_make_stage` for m <= _BLK,
    the split kernel `_make_stage_split` above) on x [L, B, n], with each
    stage's twiddles in the layout its kernel takes."""
    L, B, _ = x.shape
    jf = jax_field(modulus)
    x2 = jnp.swapaxes(jnp.asarray(x), 0, 1).reshape(B * L, n)
    for j in range(k):
        mj = m << j
        tw = table.reshape(L, mj, n // (2 * mj))[:, :, 0]                # [L, mj]
        g = n // (2 * mj)
        if mj > pk._BLK or mj >= pk._SMALL_M:                             # butterfly order
            twf = np.broadcast_to(tw[:, None, :], (L, g, mj)).reshape(L, n // 2)
        else:                                                             # interleaved
            twf = np.broadcast_to(tw[:, None, None, :], (L, g, 2, mj)).reshape(L, n)
        x2 = pk.butterfly_stage2(jf, x2, jnp.asarray(np.ascontiguousarray(twf)), L, n, mj,
                                 interpret=True)
    return np.asarray(jnp.swapaxes(x2.reshape(B, L, n), 0, 1))


# (k, lowest m) at n = 512 with the JAX split lowered to m > 64: k = 1 on
# either side of it, and passes that cross it.
PASS_CASES = [(1, 64), (1, 128), (2, 64), (3, 32)]


@pytest.mark.parametrize("modulus", [P64, P256], ids=["p64", "p256"])
@pytest.mark.parametrize("k,m", PASS_CASES, ids=[f"k{k}-m{m}" for k, m in PASS_CASES])
def test_stages_ref_matches_pallas_stages(modulus, k, m, monkeypatch):
    """butterfly_stages_ref over k stages equals k JAX Pallas stages, with
    the JAX package's split between its two stage kernels (_BLK, 4096 on
    the TPU) lowered to 64 so that both kernels run at n = 512."""
    monkeypatch.setattr(pk, "_BLK", 64)
    n, B = 512, 2
    field = create_prime_field(modulus)
    L = field.params.L
    x = _elements(np.random.default_rng(100 * k + m), modulus, L, B * n).reshape(L, B, n)
    table = power_series_mont_np(field.params, field.get_root_of_unity(n), n // 2)
    dev = field.device_field("cpu")
    xt = dev.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2)))
    got = radix2.butterfly_stages_ref(dev, xt, dev.from_numpy(np.ascontiguousarray(table.T)), m, k)
    assert got is xt
    want = _jax_stages(modulus, x, table, n, m, k)
    assert np.array_equal(dev.to_numpy(got).transpose(1, 0, 2), want)


@pytest.mark.parametrize("n,depth", [(128, 2), (512, 2), (512, 3)])
def test_direct_route_uneven_passes_match_jax(n, depth, monkeypatch):
    """P64 through the direct route with 16-point local blocks and passes of
    at most `depth` stages, the stage count (3 or 5) not a multiple of it,
    against JAX ntt and intt."""
    monkeypatch.setattr(radix2, "LOCAL_MAX", 16)
    monkeypatch.setattr(radix2, "DIRECT_ABOVE", 64)
    monkeypatch.setattr(radix2, "PASS_DEPTH", depth)
    field = create_prime_field(P64)
    dev = field.device_field("cpu")
    x = _elements(np.random.default_rng(n + depth), P64, 4, 2 * n).reshape(4, 2, n)
    x = x.transpose(1, 0, 2)
    root = field.get_root_of_unity(n)
    fwd = Radix2Plan(field, dev, n, root, 1)
    inv = Radix2Plan(field, dev, n, field.inv(root), field.inv(n))
    stages = n.bit_length() - 5
    assert stages % depth
    assert fwd.passes == radix2.stage_passes(n, 16, depth)
    assert sum(k for _, k in fwd.passes) == stages and max(k for _, k in fwd.passes) <= depth
    assert len(fwd.passes) == -(-stages // depth)
    jf, xj = jax_field(P64), jnp.asarray(x.copy())
    assert np.array_equal(dev.to_numpy(transform(dev, dev.from_numpy(x.copy()), fwd)),
                          np.asarray(jax_ntt.ntt(jf, xj)))
    assert np.array_equal(dev.to_numpy(transform(dev, dev.from_numpy(x.copy()), inv)),
                          np.asarray(jax_ntt.intt(jf, xj)))


@pytest.mark.parametrize("modulus", [P64, P256], ids=["p64", "p256"])
def test_plan_stage_table_is_element_major(modulus, monkeypatch):
    """The direct plan keeps the stage table element-major, [n/2, L]: the
    transposed half-table of the n-th root; the local table is the local
    root's half-table, limb-major [L, LOCAL_MAX/2], as kernel 8 reads it."""
    monkeypatch.setattr(radix2, "LOCAL_MAX", 16)
    monkeypatch.setattr(radix2, "DIRECT_ABOVE", 64)
    field = create_prime_field(modulus)
    dev = field.device_field("cpu")
    n = 256
    root = field.get_root_of_unity(n)
    plan = Radix2Plan(field, dev, n, root)
    half = power_series_mont_np(field.params, root, n // 2)                # [L, n/2]
    assert plan.twiddles.is_contiguous()
    assert np.array_equal(dev.to_numpy(plan.twiddles), half.T)
    local = power_series_mont_np(field.params, pow(root, n // 16, modulus), 8)
    assert plan.tables[0].is_contiguous()
    assert np.array_equal(dev.to_numpy(plan.tables[0]), local)
    assert plan.passes == [(16, 4)]


@pytest.mark.parametrize("n,depth,want", [
    (2 ** 22, 6, [(2048, 6), (2 ** 17, 5)]),
    (2 ** 24, 6, [(2048, 5), (2 ** 16, 4), (2 ** 20, 4)]),
    (4096, 6, [(2048, 1)]),
    (2 ** 21, 3, [(2048, 3), (2 ** 14, 3), (2 ** 17, 2), (2 ** 19, 2)]),
])
def test_stage_passes(n, depth, want):
    """The passes cover the stages m .. n/2 in order, as few as the depth
    allows, deeper ones first."""
    assert radix2.stage_passes(n, 2048, depth) == want


def test_stages_ref_is_successive_single_stages():
    """butterfly_stages_ref(m, k) is butterfly_stage_ref at m, 2m, ...,
    in place, and the CPU wrapper runs it."""
    field = create_prime_field(P256)
    dev = field.device_field("cpu")
    n = 64
    x = dev.from_numpy(_elements(np.random.default_rng(7), P256, 16, 3 * n)
                       .reshape(16, 3, n).transpose(1, 0, 2).copy())
    table = dev.from_numpy(np.ascontiguousarray(
        power_series_mont_np(field.params, field.get_root_of_unity(n), n // 2).T))
    want = x.clone()
    for m in (2, 4, 8, 16):
        radix2.butterfly_stage_ref(dev, want, table, m)
    got = x.clone()
    assert radix2.butterfly_stages(dev, got, table, 2, 4) is got
    assert np.array_equal(dev.to_numpy(got), dev.to_numpy(want))
