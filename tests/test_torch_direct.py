"""The direct radix-2 route of the port (ntt/radix2.py: bit reversal, the
bit-reversed entry of kernel 8, the large stages in fused passes) and its
plain stages (kernels 7 and 9) against the JAX package, exactly (tolerance
0).  Inputs are numpy limbs from fixed seeds; the JAX Pallas kernels run in
interpret mode, as tests/test_pallas_ntt.py runs them.

The route's thresholds (`radix2.LOCAL_MAX`, `radix2.DIRECT_ABOVE`) are
lowered so that the direct route runs at sizes whose JAX transforms compile
quickly; P224 and P256 are held to the port's own four-step route (held to
JAX in test_torch_radix2.py) to avoid new wide-field XLA compiles."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genstark_tpu import ntt as jax_ntt
from genstark_tpu.field import create_prime_field as jax_field
from genstark_tpu.ntt import _bitrev_indices
from genstark_tpu.ntt import pallas_kernels as pk
from genstark_tpu_torch.field import P64, P224, P256, create_prime_field
from genstark_tpu_torch.field.limbs import power_series_mont_np
from genstark_tpu_torch.ntt import Radix2Plan, radix2, transform

P256_64_PIN = (40300, "aeca982219743b04f13dd8b6be2b855f951bb16fd4c837f841d62af059265be4")
P64_64_PIN = (4614, "8f2cc12a4eea675682570374637c919519eb1c5628201c0d5b99a9a5892f6fe9")
TOY = {"extension_factor": 4, "exe_query_count": 8, "fri_query_count": 6}


def _elements(rng, modulus, L, n):
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, modulus >> (16 * (L - 1)), size=n)
    return limbs.astype(np.uint32)


def _stage_inputs(modulus, n, B, seed):
    """x u32 [L, B, n] (the JAX kernels' layout) and the n-th root's
    half-table u32 [L, n/2]."""
    field = create_prime_field(modulus)
    L = field.params.L
    x = _elements(np.random.default_rng(seed), modulus, L, B * n).reshape(L, B, n)
    table = power_series_mont_np(field.params, field.get_root_of_unity(n), n // 2)
    return field, x, table


def _port_stage(field, x, table, m):
    """The plain stage (a one-stage pass, on the element-major table) on the
    port's [B, L, n] layout, back to [L, B, n]."""
    dev = field.device_field("cpu")
    xt = dev.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2)))
    got = radix2.butterfly_stages(dev, xt, dev.from_numpy(np.ascontiguousarray(table.T)), m, 1)
    return dev.to_numpy(got).transpose(1, 0, 2)


def _butterfly_order(table, L, n, m):
    """[L, n/2] twiddles in butterfly order (tw of butterfly i at column
    i), and the [L, n] interleaved form the roll variant takes."""
    tw = table.reshape(L, m, (n // 2) // m)[:, :, 0]
    g = n // (2 * m)
    return (np.broadcast_to(tw[:, None, :], (L, g, m)).reshape(L, n // 2),
            np.broadcast_to(tw[:, None, None, :], (L, g, 2, m)).reshape(L, n))


STAGE_CASES = [(P64, 1), (P64, 64), (P64, 256), (P256, 64)]


@pytest.mark.parametrize("modulus,m", STAGE_CASES,
                         ids=[f"p{mod.bit_length()}-m{m}" for mod, m in STAGE_CASES])
def test_stage_ref_matches_pallas_stage(modulus, m):
    """Kernel 7: the plain stage equals pallas_kernels.butterfly_stage
    (both of its in-kernel strategies: lane rolls for m < 256, aligned
    reshape above)."""
    n, B = 1024, 2
    field, x, table = _stage_inputs(modulus, n, B, seed=m)
    L = field.params.L
    twf, twi = _butterfly_order(table, L, n, m)
    tw_in = twf if m >= pk._SMALL_M else twi
    want = pk.butterfly_stage(jax_field(modulus), jnp.asarray(x), jnp.asarray(tw_in), n, m,
                              interpret=True)
    assert np.array_equal(_port_stage(field, x, table, m), np.asarray(want))


@pytest.mark.parametrize("modulus", [P64, P256], ids=["p64", "p256"])
def test_stage_ref_matches_pallas_split_stage(modulus):
    """Kernel 9: the plain stage equals the large-m split kernel (lo / hi
    fetched as block-aligned views, re-interleaved after)."""
    n, B, m, blk = 1024, 2, 256, 64
    field, x, table = _stage_inputs(modulus, n, B, seed=5)
    L = field.params.L
    jdev = jax_field(modulus).device
    fn = pk._stage_fn_split(L, jdev._p_np.tobytes(), int(jdev._n0p), n, B, m, blk, True)
    x2 = jnp.swapaxes(jnp.asarray(x), 0, 1).reshape(B * L, n)
    twf, _ = _butterfly_order(table, L, n, m)
    want = jnp.swapaxes(fn(x2, jnp.asarray(twf)).reshape(B, L, n), 0, 1)
    assert np.array_equal(_port_stage(field, x, table, m), np.asarray(want))


@pytest.mark.parametrize("n,mblk", [(64, 2048), (256, 16)], ids=["one-block", "blocks"])
def test_bitrev_butterfly_matches_pallas_multistage(n, mblk, monkeypatch):
    """Kernel 8's bit-reversed entry: the plain local transforms over the
    contiguous blocks of a bit-reversed array equal pallas_kernels.
    multistage fed the same bit-reversed input (one block of all stages,
    and 2*mblk-point blocks with the stages m <= mblk)."""
    monkeypatch.setattr(pk, "_MBLK", mblk)
    B = 2
    field, x, table = _stage_inputs(P64, n, B, seed=n)
    L = field.params.L
    dev = field.device_field("cpu")
    xr = np.ascontiguousarray(np.asarray(jnp.take(jnp.asarray(x), _bitrev_indices(n), axis=-1)))
    want, last_m = pk.multistage(jax_field(P64), jnp.swapaxes(jnp.asarray(xr), 0, 1)
                                 .reshape(B * L, n), jnp.asarray(table), L, n, interpret=True)
    local = 2 * last_m
    blocks = dev.from_numpy(xr.transpose(1, 0, 2).copy()).view(B, L, n // local, local)
    local_table = dev.from_numpy(table.reshape(L, local // 2, n // local)[:, :, 0].copy())
    got = radix2.butterfly(dev, blocks.permute(0, 2, 1, 3), local_table, bitrev_in=True)
    got = got.permute(0, 2, 1, 3).reshape(B * L, n)
    assert np.array_equal(dev.to_numpy(got), np.asarray(want))


@pytest.fixture
def direct(monkeypatch):
    """Lower the thresholds: local transforms of 16 points, the direct
    route above `above` points."""
    def set_(above, local=16):
        monkeypatch.setattr(radix2, "LOCAL_MAX", local)
        monkeypatch.setattr(radix2, "DIRECT_ABOVE", above)
    return set_


@pytest.mark.parametrize("n", [128, 512])
def test_direct_route_matches_jax_ntt_intt(n, direct):
    """P64 through the direct route (16-point local pass, then stages
    m = 16 .. n/2) against JAX ntt and intt."""
    direct(64)
    field = create_prime_field(P64)
    dev = field.device_field("cpu")
    x = _elements(np.random.default_rng(n), P64, 4, 2 * n).reshape(4, 2, n).transpose(1, 0, 2)
    root = field.get_root_of_unity(n)
    fwd = Radix2Plan(field, dev, n, root, 1)
    inv = Radix2Plan(field, dev, n, field.inv(root), field.inv(n))
    assert fwd.route == inv.route == "direct"
    jf, xj = jax_field(P64), jnp.asarray(x.copy())
    assert np.array_equal(dev.to_numpy(transform(dev, dev.from_numpy(x.copy()), fwd)),
                          np.asarray(jax_ntt.ntt(jf, xj)))
    assert np.array_equal(dev.to_numpy(transform(dev, dev.from_numpy(x.copy()), inv)),
                          np.asarray(jax_ntt.intt(jf, xj)))


def test_direct_route_lde_matches_jax(direct):
    """The prover's standard-form LDE (R^-1 as the direct route's scale)
    against the JAX LDE then from-Montgomery, P64, 16 -> 256 points."""
    direct(64)
    n, T = 256, 16
    field = create_prime_field(P64)
    dev = field.device_field("cpu")
    jf = jax_field(P64)
    coeffs = _elements(np.random.default_rng(3), P64, 4, T)
    plan = Radix2Plan(field, dev, n, field.get_root_of_unity(n),
                      field.inv(field.params.R_mod % P64))
    assert plan.route == "direct"
    got = transform(dev, dev.from_numpy(np.pad(coeffs, ((0, 0), (0, n - T)))), plan)
    want = jf.device.from_mont(jax_ntt.low_degree_extend(jf, jnp.asarray(coeffs), n))
    assert np.array_equal(dev.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("modulus", [P224, P256], ids=["p224", "p256"])
@pytest.mark.parametrize("n", [128, 512])
def test_direct_route_matches_four_step(modulus, n, monkeypatch):
    """P224 and P256: the direct route equals the port's four-step route
    (32-point rows) forward, inverse and with R^-1, on a [2, L, n] batch;
    the plain-only transform_ref equals the dispatching one."""
    field = create_prime_field(modulus)
    dev = field.device_field("cpu")
    L = dev.L
    x = dev.from_numpy(_elements(np.random.default_rng(n), modulus, L, 2 * n)
                       .reshape(L, 2, n).transpose(1, 0, 2).copy())
    root = field.get_root_of_unity(n)
    for r, scale in ((root, 1), (field.inv(root), field.inv(n)),
                     (root, field.inv(field.params.R_mod % modulus))):
        monkeypatch.setattr(radix2, "LOCAL_MAX", 16)
        monkeypatch.setattr(radix2, "DIRECT_ABOVE", 64)
        d = Radix2Plan(field, dev, n, r, scale)
        monkeypatch.setattr(radix2, "LOCAL_MAX", 32)
        monkeypatch.setattr(radix2, "DIRECT_ABOVE", 1 << 30)
        f4 = Radix2Plan(field, dev, n, r, scale)
        assert (d.route, f4.route) == ("direct", "four_step")
        got = transform(dev, x, d)
        assert torch.equal(got, transform(dev, x, f4))
        assert torch.equal(got, radix2.transform_ref(dev, x, d))


def test_direct_route_stage_sequence(direct, monkeypatch):
    """One direct n-point transform runs one local pass over n/LOCAL_MAX
    bit-reversed blocks, then the stages m = LOCAL_MAX .. n/2 in order, in
    passes of at most PASS_DEPTH stages (at 2^22 points and LOCAL_MAX 2048:
    m = 2048 .. 2^16, one row-7 pass, then m = 2^17 .. 2^21, one row-9
    pass; at 2^24 one row-7 pass and two row-9 passes)."""
    from genstark_tpu_torch import kernels
    direct(64)
    monkeypatch.setattr(radix2, "PASS_DEPTH", 2)
    calls = []
    real_stages, real_bfly = radix2.butterfly_stages, radix2.butterfly
    monkeypatch.setattr(radix2, "butterfly_stages", lambda dev, x, t, m, k: (
        calls.append(("stages", m, k)) or real_stages(dev, x, t, m, k)))
    monkeypatch.setattr(radix2, "butterfly", lambda dev, x, t, out=None, bitrev_in=False: (
        calls.append(("local", tuple(x.shape), bitrev_in)) or real_bfly(dev, x, t, out, bitrev_in)))
    field = create_prime_field(P64)
    dev = field.device_field("cpu")
    n = 512
    plan = Radix2Plan(field, dev, n, field.get_root_of_unity(n))
    transform(dev, dev.zeros((n,)), plan)
    assert calls == [("local", (1, n // 16, 4, 16), True),
                     ("stages", 16, 2), ("stages", 64, 2), ("stages", 256, 1)]
    passes = {n: radix2.stage_passes(n, 2048, 6) for n in (2 ** 22, 2 ** 23, 2 ** 24)}
    assert passes == {2 ** 22: [(2048, 6), (2 ** 17, 5)], 2 ** 23: [(2048, 6), (2 ** 17, 6)],
                      2 ** 24: [(2048, 5), (2 ** 16, 4), (2 ** 20, 4)]}
    for ps in passes.values():
        assert [m <= kernels.STAGE_SPLIT_ABOVE for m, _ in ps] == [True] + [False] * (len(ps) - 1)


@pytest.mark.parametrize("case", ["p256", "p64"])
def test_proofs_through_direct_route_equal_pins(case, direct):
    """The 64-step MiMC proofs with every transform of 64 points or more on
    the direct route equal the JAX package's pinned bytes."""
    from examples.mimc_torch import prove_mimc
    direct(32)
    modulus, options, pin = {"p256": (P256, None, P256_64_PIN),
                             "p64": (P64, TOY, P64_64_PIN)}[case]
    stark, data = prove_mimc(64, "cpu", modulus=modulus, options=options)
    plans = next(iter(stark._provers.values()))._get_plans()
    assert {k: p.route for k, p in plans.items()} == dict.fromkeys(plans, "direct")
    assert (len(data), hashlib.sha256(data).hexdigest()) == pin
