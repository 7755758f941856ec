"""Kernels against their plain versions on a CUDA card, exactly.  Marked
`cuda`: each test skips where torch sees no card (this decision is taken in
the fixture, never at import).  On the machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:xdist
"""

import numpy as np
import pytest
import torch

from genstark_tpu_torch.field import P32, P64, P128, P224, P256, create_prime_field

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _elements(rng, modulus, L, n):
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, modulus >> (16 * (L - 1)), size=n)
    return limbs.astype(np.uint32)


@pytest.mark.parametrize("modulus", [P32, P128], ids=["p32", "p128"])
@pytest.mark.parametrize("n", [64, 2 ** 12])
def test_dft_levels_kernel_equals_plain(device, modulus, n):
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.ntt import DftPlan, dft
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    plan = DftPlan(field, dev, n, field.get_root_of_unity(n), 3)
    rng = np.random.default_rng(n)
    rest = n
    for lvl, m in enumerate(plan.levels):
        rest //= m
        x = dev.from_numpy(_elements(rng, modulus, dev.L, n)).reshape(dev.L, m, n // m)
        x8 = dft.encode_digits(x).contiguous()
        for out_digits in (False, True):
            args = (dev, plan.w8s[lvl], x8, m, rest, plan.tws[lvl] if rest > 1 else None,
                    out_digits)
            assert torch.equal(kernels.dft_level(*args), dft.run_dft_level_ref(*args))


@pytest.mark.parametrize("algo", ["sha256", "blake2s256"])
def test_hash_kernels_equal_plain(device, algo):
    from genstark_tpu_torch.hash import digest_rows_ref, create_hash, elements_to_words
    h = create_hash(algo)
    rng = np.random.default_rng(5)
    words = torch.as_tensor(rng.integers(0, 1 << 32, size=(16, 1000), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32), device=device)
    assert torch.equal(h.digest_rows(words, 64), digest_rows_ref(algo, words, 64))
    vecs = torch.as_tensor(np.stack([_elements(rng, P128, 8, 1024)] * 2).astype(np.int32),
                           device=device)
    want = digest_rows_ref(algo, torch.cat([elements_to_words(vecs[v]) for v in range(2)]), 32)
    assert torch.equal(h.merge_element_rows(vecs, 16), want)
    rows = h.digest_stride_rows(vecs[0], 16)
    want = digest_rows_ref(algo, torch.cat(
        [elements_to_words(vecs[0][:, k * 256:(k + 1) * 256]) for k in range(4)]), 64)
    assert torch.equal(rows, want)


def test_lcomb_tail_kernel_equals_plain(device):
    from genstark_tpu_torch.field.limbs import power_series_mont_np
    from genstark_tpu_torch.protocol.lincomb_kernel import lcomb_tail, lcomb_tail_ref
    field = create_prime_field(P128)
    dev = field.device_field(device)
    p = field.modulus
    Ne, s, ext = 4096, 64, 16
    rng = np.random.default_rng(9)
    rnd = lambda n: dev.from_numpy(_elements(rng, p, 8, n))
    g = field.get_root_of_unity(Ne)
    dom = (dev.from_numpy(power_series_mont_np(field.params, pow(g, s, p), Ne // s)),
           dev.from_numpy(power_series_mont_np(field.params, g, s)))
    args = (dev, rnd(Ne), torch.stack([rnd(Ne)]), torch.stack([rnd(Ne), rnd(Ne)]),
            dom, dom, rnd(ext), 12345, rnd(2), rnd(4), True, True, ext)
    assert torch.equal(lcomb_tail(*args), lcomb_tail_ref(*args))


def test_pins_on_card(device):
    import hashlib
    from examples.mimc_torch import prove_mimc
    opts = {"extension_factor": 4, "exe_query_count": 8, "fri_query_count": 6}
    _, data = prove_mimc(64, device, modulus=P128, use_input=False, constant_count=32,
                         options=opts)
    assert (len(data), hashlib.sha256(data).hexdigest()) == (
        7329, "3fa3bc9f84d3505912258df9974587b18b35619116a2787786b3beacd3cc4917")


ALL_FIELDS = pytest.mark.parametrize("modulus", [P32, P64, P128, P224, P256],
                                     ids=["p32", "p64", "p128", "p224", "p256"])


def _pm1(field, n):
    from genstark_tpu_torch.field.limbs import ints_to_limbs
    return ints_to_limbs([field.modulus - 1] * n, field.params.L)


@ALL_FIELDS
def test_field_ew_kernel_equals_plain_and_counts(device, modulus):
    """Kernel 5: every op, same-shape operands, a scalar on either side,
    p - 1, a strided column view and a batch against a [L, 1, 1] constant;
    each call launches the kernel exactly once."""
    from genstark_tpu_torch import kernels
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    L = dev.L
    rng = np.random.default_rng(modulus % 991)
    a = dev.from_numpy(_elements(rng, modulus, L, 4096))
    b = dev.from_numpy(_elements(rng, modulus, L, 4096))
    c = dev.from_numpy(_elements(rng, modulus, L, 1))
    pm1 = dev.from_numpy(_pm1(field, 4096))
    cols = dev.from_numpy(_elements(rng, modulus, L, 4 * 1024)).reshape(L, 4, 1024)
    batch = dev.from_numpy(_elements(rng, modulus, L, 3 * 4096)).reshape(L, 3, 4096)
    pairs = [(a, b), (a, c), (c, a), (pm1, pm1), (cols[:, 1], a[:, :1024]),
             (batch, c.reshape(L, 1, 1))]
    for pub, ref in ((dev.mont_mul, dev.mont_mul_ref), (dev._add, dev.add_ref),
                     (dev._sub, dev.sub_ref)):
        for x, y in pairs:
            before = kernels.launch_counts["field_ew"]
            got = pub(x, y)
            assert kernels.launch_counts["field_ew"] == before + 1
            assert torch.equal(got, ref(x, y))


@pytest.mark.parametrize("modulus", [P128, P256], ids=["p128", "p256"])
def test_outer_table_kernel_equals_plain(device, modulus):
    from genstark_tpu_torch import kernels
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    rng = np.random.default_rng(3)
    outer = dev.from_numpy(_elements(rng, modulus, dev.L, 512))
    inner = dev.from_numpy(_elements(rng, modulus, dev.L, 256))
    before = kernels.launch_counts["outer_table"]
    got = dev.outer_table(outer, inner)
    assert kernels.launch_counts["outer_table"] == before + 1
    assert torch.equal(got, dev.outer_table_ref(outer, inner))


def test_field_kernels_raise_on_unsupported_shapes(device):
    """What the kernel does not take raises; nothing runs plain torch."""
    from genstark_tpu_torch import kernels
    dev = create_prime_field(P128).device_field(device)
    a = torch.zeros((8, 2, 2, 2, 2, 2), dtype=torch.int32, device=device)
    b = torch.zeros((8, 2, 1, 2, 1, 2), dtype=torch.int32, device=device)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="batch dims"):
        dev.mont_mul(a, b)
    with pytest.raises(TypeError):
        dev._add(a.long(), a.long())
    with pytest.raises(ValueError):
        dev.outer_table(a[:, 0, 0, 0, 0], a[:, 0, 0, 0])
    assert kernels.launch_counts == before


@ALL_FIELDS
def test_radix2_kernels_equal_plain(device, modulus):
    """Kernel 8 at a direct local size and inside the four-step split of a
    2^13-point transform (kernels 8 and 5), against the plain path."""
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.ntt import radix2
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    rng = np.random.default_rng(modulus % 89)
    for n in (2048, 2 ** 13):
        plan = radix2.Radix2Plan(field, dev, n, field.get_root_of_unity(n), 7)
        x = dev.from_numpy(_elements(rng, modulus, dev.L, 2 * n)).reshape(dev.L, 2, n)
        x = x.permute(1, 0, 2)
        before = kernels.launch_counts["butterfly"]
        got = radix2.transform(dev, x, plan)
        assert kernels.launch_counts["butterfly"] == before + (1 if n == 2048 else 2)
        assert torch.equal(got, radix2.transform_ref(dev, x, plan))


def test_hash_and_tail_kernels_at_l16(device):
    """Kernel 3 on 64-byte P256 leaves (V = 2) and 128-byte FRI rows (two
    blake2s blocks), kernel 4 at L = 16, against their plain versions."""
    from genstark_tpu_torch.field import P256
    from genstark_tpu_torch.field.limbs import power_series_mont_np
    from genstark_tpu_torch.hash import create_hash, digest_rows_ref, elements_to_words
    from genstark_tpu_torch.protocol.lincomb_kernel import lcomb_tail, lcomb_tail_ref
    rng = np.random.default_rng(13)
    vecs = torch.as_tensor(np.stack([_elements(rng, P256, 16, 1024)] * 2).astype(np.int32),
                           device=device)
    for algo in ("sha256", "blake2s256"):
        h = create_hash(algo)
        want = digest_rows_ref(algo, torch.cat([elements_to_words(vecs[v]) for v in range(2)]),
                               64)
        assert torch.equal(h.merge_element_rows(vecs, 32), want)
        want = digest_rows_ref(algo, torch.cat(
            [elements_to_words(vecs[0][:, k * 256:(k + 1) * 256]) for k in range(4)]), 128)
        assert torch.equal(h.digest_stride_rows(vecs[0], 32), want)
    field = create_prime_field(P256)
    dev = field.device_field(device)
    p = field.modulus
    Ne, s, ext = 4096, 64, 16
    rnd = lambda n: dev.from_numpy(_elements(rng, p, 16, n))
    g = field.get_root_of_unity(Ne)
    dom = (dev.from_numpy(power_series_mont_np(field.params, pow(g, s, p), Ne // s)),
           dev.from_numpy(power_series_mont_np(field.params, g, s)))
    args = (dev, rnd(Ne), torch.stack([rnd(Ne)]), torch.stack([rnd(Ne), rnd(Ne)]),
            dom, dom, rnd(ext), 12345, rnd(2), rnd(4), True, True, ext)
    assert torch.equal(lcomb_tail(*args), lcomb_tail_ref(*args))


def test_mimc256_pin_on_card(device):
    import hashlib
    from examples.mimc_torch import prove_mimc
    from genstark_tpu_torch.field import P256
    _, data = prove_mimc(64, device, modulus=P256)
    assert (len(data), hashlib.sha256(data).hexdigest()) == (
        40300, "aeca982219743b04f13dd8b6be2b855f951bb16fd4c837f841d62af059265be4")
