"""Kernels against their plain versions on a CUDA card, exactly.  Marked
`cuda`: each test skips where torch sees no card (this decision is taken in
the fixture, never at import).  On the machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:xdist
"""

import numpy as np
import pytest
import torch

from genstark_tpu_torch.field import P32, P128, create_prime_field

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
