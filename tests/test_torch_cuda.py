"""Kernels against their plain versions on a CUDA card, exactly.  Marked
`cuda`: each test skips where torch sees no card (this decision is taken in
the fixture, never at import).  On the machine with the card:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -m cuda
"""

import numpy as np
import pytest
import torch

from genstark_tpu_torch import testing
from genstark_tpu_torch.field import P32, P64, P128, P224, P256, create_prime_field
from genstark_tpu_torch.testing import (GOLDILOCKS, SOLINAS96, SOLINAS160, SOLINAS192,
                                        edge_input, edge_pairs, edge_values)

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


@pytest.mark.parametrize("modulus", [P32, GOLDILOCKS, SOLINAS96, P128, SOLINAS160, SOLINAS192,
                                     P224, P256],
                         ids=["p32", "goldilocks", "p96", "p128", "p160", "p192", "p224", "p256"])
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
    assert (len(data), hashlib.sha256(data).hexdigest()) == testing.P128_PIN


ALL_FIELDS = pytest.mark.parametrize(
    "modulus", [P32, P64, SOLINAS96, P128, SOLINAS160, SOLINAS192, P224, P256],
    ids=["p32", "p64", "p96", "p128", "p160", "p192", "p224", "p256"])


@pytest.mark.parametrize("modulus,pin", [(SOLINAS96, "SOLINAS96_64_PIN"),
                                         (SOLINAS160, "SOLINAS160_64_PIN"),
                                         (SOLINAS192, "SOLINAS192_64_PIN")],
                         ids=["p96", "p160", "p192"])
def test_mid_limb_toy_pins_on_card(device, modulus, pin):
    """MiMC over the solinas moduli of 96, 160 and 192 bits (kernel 1 at L
    = 6, 10 and 12), the toy options with blake2s256: the JAX package's
    bytes."""
    import hashlib
    from examples.mimc_torch import prove_mimc
    opts = {"hash_algorithm": "blake2s256", "extension_factor": 4, "exe_query_count": 8,
            "fri_query_count": 6}
    _, data = prove_mimc(64, device, modulus=modulus, options=opts)
    assert (len(data), hashlib.sha256(data).hexdigest()) == getattr(testing, pin)


def _pm1(field, n):
    from genstark_tpu_torch.field.limbs import ints_to_limbs
    return ints_to_limbs([field.modulus - 1] * n, field.params.L)


@ALL_FIELDS
def test_field_ew_kernel_equals_plain_and_counts(device, modulus):
    """Kernel 5: every op, same-shape operands (every ordered pair of edge values
    among them), a scalar on either side and a batch against a [L, 1, 1]
    constant (a random scalar, 0, 1 and p - 1), p - 1, and a strided column
    view; each call launches the kernel exactly once."""
    from genstark_tpu_torch import kernels
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    L = dev.L
    rng = np.random.default_rng(modulus % 991)
    ab = dev.from_numpy(edge_input(field, _elements(rng, modulus, L, 2 * 4096)))
    ab = ab.reshape(L, 2, 4096)
    a, b = ab[:, 0].contiguous(), ab[:, 1].contiguous()       # every edge pair at a[i], b[i]
    c = dev.from_numpy(_elements(rng, modulus, L, 1))
    pm1 = dev.from_numpy(_pm1(field, 4096))
    cols = dev.from_numpy(_elements(rng, modulus, L, 4 * 1024)).reshape(L, 4, 1024)
    batch = dev.from_numpy(_elements(rng, modulus, L, 3 * 4096)).reshape(L, 3, 4096)
    scalars = [c] + [dev.from_ints([v], to_mont=False) for v in (0, 1, modulus - 1)]
    pairs = [(a, b), (pm1, pm1), (cols[:, 1], a[:, :1024])]
    for k in scalars:
        pairs += [(a, k), (k, a), (batch, k.reshape(L, 1, 1))]
    for pub, ref in ((dev.mont_mul, dev.mont_mul_ref), (dev._add, dev.add_ref),
                     (dev._sub, dev.sub_ref)):
        for x, y in pairs:
            before = kernels.launch_counts["field_ew"]
            got = pub(x, y)
            assert kernels.launch_counts["field_ew"] == before + 1
            assert torch.equal(got, ref(x, y))


@ALL_FIELDS
@pytest.mark.parametrize("nj,s", [(512, 256), (2048, 2048), (37, 300), (1, 1), (3, 1000)])
def test_outer_table_kernel_equals_plain(device, modulus, nj, s):
    """Kernel 6 (word product): the path's tables, a 2^22-product table, an
    s that is not a power of two, one element, and rows of several column
    tiles; p - 1 in both factors.  One launch each."""
    from genstark_tpu_torch import kernels
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    rng = np.random.default_rng(nj + s)
    outer = dev.from_numpy(_elements(rng, modulus, dev.L, nj))
    inner = dev.from_numpy(_elements(rng, modulus, dev.L, s))
    outer[:, :1] = torch.as_tensor(_pm1(field, 1).astype(np.int32), device=device)
    inner[:, -1:] = torch.as_tensor(_pm1(field, 1).astype(np.int32), device=device)
    before = kernels.launch_counts["outer_table"]
    got = dev.outer_table(outer, inner)
    assert kernels.launch_counts["outer_table"] == before + 1
    assert torch.equal(got, dev.outer_table_ref(outer, inner))


def _limbs_plain(algo, values, form, elem):
    from genstark_tpu_torch.hash import digest_rows_ref, elements_to_words
    if form == "rows":
        M = values.shape[1] // 4
        parts = [values[:, k * M:(k + 1) * M] for k in range(4)]
    else:
        parts = list(values)
    return digest_rows_ref(algo, torch.cat([elements_to_words(t) for t in parts]),
                           len(parts) * elem)


@ALL_FIELDS
@pytest.mark.parametrize("algo", ["sha256", "blake2s256"])
def test_hash_limbs_forms_equal_plain(device, modulus, algo):
    """Kernel 3: leaves of 1, 2 and 4 vectors (compile-time form) and of 3
    (runtime form), and stride-4 rows, at 1, 255 and 2^17 messages; through
    the Hash entry points for the leaves of two vectors and the rows.  One
    launch each."""
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.hash import create_hash
    field = create_prime_field(modulus)
    L, elem = field.params.L, field.element_size
    rng = np.random.default_rng(modulus % 67)
    h = create_hash(algo)
    for form in (1, 2, 3, 4, "rows"):
        for batch in (1, 255, 2 ** 17):
            if form == "rows":
                values = torch.as_tensor(_elements(rng, modulus, L, 4 * batch).astype(np.int32),
                                         device=device)
            else:
                values = torch.as_tensor(np.stack([_elements(rng, modulus, L, batch)
                                                   for _ in range(form)]).astype(np.int32),
                                         device=device)
            want = _limbs_plain(algo, values, form, elem)
            before = kernels.launch_counts["hash_limbs"]
            assert torch.equal(kernels.hash_limbs(algo, values, rows=form == "rows"), want)
            if form == "rows":
                assert torch.equal(h.digest_stride_rows(values, elem), want)
            elif form == 2:
                assert torch.equal(h.merge_element_rows(values, elem), want)
            assert kernels.launch_counts["hash_limbs"] == before + (2 if form in (2, "rows") else 1)


@pytest.mark.parametrize("algo", ["sha256", "blake2s256"])
@pytest.mark.parametrize("form", [2, "rows"])
def test_hash_limbs_at_2_22_messages(device, algo, form):
    """Kernel 3 at the 2^18-step path's 2^22 messages over P256: leaves of
    two vectors and stride-4 rows (the plain version in column chunks)."""
    from genstark_tpu_torch import kernels
    field = create_prime_field(P256)
    L, elem, B = 16, field.element_size, 2 ** 22
    g = torch.Generator(device=device)
    g.manual_seed(7)
    shape = (L, 4 * B) if form == "rows" else (2, L, B)
    values = torch.randint(0, 1 << 16, shape, generator=g, device=device, dtype=torch.int32)
    got = kernels.hash_limbs(algo, values, rows=form == "rows")
    chunk = 1 << 20
    for i0 in range(0, B, chunk):
        if form == "rows":
            part = torch.cat([values[:, k * B + i0:k * B + i0 + chunk] for k in range(4)], dim=1)
        else:
            part = values[..., i0:i0 + chunk]
        assert torch.equal(got[:, i0:i0 + chunk], _limbs_plain(algo, part, form, elem))


def test_hash_limbs_raises_on_unsupported_layouts(device):
    from genstark_tpu_torch import kernels
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="N % 4"):
        kernels.hash_limbs("sha256", torch.zeros((8, 6), dtype=torch.int32, device=device), True)
    with pytest.raises(ValueError, match="L in"):     # L = 18: above 256 bits
        kernels.hash_limbs("sha256", torch.zeros((2, 18, 8), dtype=torch.int32, device=device),
                           False)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.hash_limbs("sha256", torch.zeros((2, 8, 8), dtype=torch.int32,
                                                 device=device).transpose(1, 2), False)
    assert kernels.launch_counts == before


@ALL_FIELDS
def test_inv_on_card_equals_plain(device, modulus):
    """DeviceField.inv on the card: every product one kernel-5 launch (2
    ceil(log2 N) + 2) and the total's inverse one kernel-A launch, equal to
    inv_ref, zeros (first, inside, last) and a batched shape included."""
    from genstark_tpu_torch import kernels
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    rng = np.random.default_rng(modulus % 73)
    for shape in ((1,), (2,), (4099,), (3, 16)):
        n = int(np.prod(shape))
        a = _elements(rng, modulus, dev.L, n)
        if n > 2:
            a[:, [0, n // 2, n - 1]] = 0
        x = dev.from_numpy(a).reshape((dev.L,) + shape)
        before = kernels.launch_counts["field_ew"]
        invs = kernels.launch_counts["mont_inv"]
        got = dev.inv(x)
        assert kernels.launch_counts["field_ew"] == before + 2 * (n - 1).bit_length() + 2
        assert kernels.launch_counts["mont_inv"] == invs + 1
        assert torch.equal(got, dev.inv_ref(x))


def test_division_pin_on_card(device):
    import hashlib
    from examples.mimc_torch import prove_div
    _, data = prove_div(64, device)
    assert (len(data), hashlib.sha256(data).hexdigest()) == testing.DIV_PIN


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
    assert (len(data), hashlib.sha256(data).hexdigest()) == testing.P256_64_PIN


def _stage_table(field, dev, n):
    """The n-th root's stage table [n/2, L], element-major."""
    from genstark_tpu_torch.field.limbs import power_series_mont_np
    return dev.from_numpy(np.ascontiguousarray(
        power_series_mont_np(field.params, field.get_root_of_unity(n), n // 2).T))


@ALL_FIELDS
def test_stage_kernels_equal_plain_and_count(device, modulus):
    """Kernels 7 and 9: passes of k = 1 stage at m on both sides of 4096,
    and of k = 2 .. 6 stages from the least m (16) up, against
    butterfly_stages_ref, in place, every ordered pair of edge values added
    and subtracted at the first butterflies of each pass from m >= 128 (row
    0; the first 16 pairs from m = 16 and 32 in row 1); a pass from m <=
    4096 counts as `bfly_stage`, a larger m as `bfly_stage_split`, one
    launch each.  A pass from m < 16 raises and launches nothing."""
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.ntt import radix2
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    n = 2 ** 14
    rng = np.random.default_rng(modulus % 97)
    runs = ((2048, 1), (4096, 1), (8192, 1), (16, 4), (32, 2), (128, 3), (16, 6), (256, 6),
            (2048, 3), (4096, 2))
    root = field.get_root_of_unity(n)
    x = np.stack([edge_input(field, _elements(rng, modulus, dev.L, n),
                             sorted({m for m, _ in runs if m >= 128}), root=root),
                  edge_input(field, _elements(rng, modulus, dev.L, n), (16, 32), root=root)])
    x = dev.from_numpy(x)
    table = _stage_table(field, dev, n)
    for m, k in runs:
        row = "bfly_stage" if m <= 4096 else "bfly_stage_split"
        before = dict(kernels.launch_counts)
        got = radix2.butterfly_stages(dev, x.clone(), table, m, k)
        assert kernels.launch_counts[row] == before[row] + 1
        assert sum(kernels.launch_counts.values()) == sum(before.values()) + 1
        assert torch.equal(got, radix2.butterfly_stages_ref(dev, x.clone(), table, m, k))
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="m >= 16"):
        radix2.butterfly_stages(dev, x.clone(), table, 8, 2)
    assert kernels.launch_counts == before


@ALL_FIELDS
def test_fused_passes_of_the_2_22_route_equal_plain(device, modulus):
    """The two passes the direct route runs at 2^22 points (6 stages from
    m = 2048, 5 from 2^17) against butterfly_stages_ref, one row, every
    ordered pair of edge values added and subtracted at each pass's first
    butterflies."""
    from genstark_tpu_torch.ntt import radix2
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    n = 2 ** 22
    table = _stage_table(field, dev, n)
    passes = radix2.stage_passes(n, radix2.LOCAL_MAX, radix2.PASS_DEPTH)
    assert passes == [(2048, 6), (2 ** 17, 5)]
    x = edge_input(field, _elements(np.random.default_rng(modulus % 71), modulus, dev.L, n),
                   [m for m, _ in passes], root=field.get_root_of_unity(n))
    x = dev.from_numpy(x)[None]
    for m, k in passes:
        got = radix2.butterfly_stages(dev, x.clone(), table, m, k)
        assert torch.equal(got, radix2.butterfly_stages_ref(dev, x.clone(), table, m, k))


@ALL_FIELDS
def test_butterfly_kernel_layouts_equal_plain(device, modulus):
    """Kernel 8 at every local size from 2 to butterfly_max_n(L), both
    entries, on contiguous views (16-byte accesses) and on strided ones
    (column views in, a permuted output), out of place and in place; the
    contiguous rows hold the ordered pairs of edge values at their first
    butterflies."""
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.field.limbs import power_series_mont_np
    from genstark_tpu_torch.ntt import radix2
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    L = dev.L
    rng = np.random.default_rng(modulus % 61)
    n = 2
    while n <= kernels.butterfly_max_n(L):
        table = dev.from_numpy(power_series_mont_np(
            field.params, field.get_root_of_unity(n), n // 2))
        B, G = 2, 3
        x = dev.from_numpy(np.stack([edge_input(field, _elements(rng, modulus, L, n))
                                     for _ in range(B * G)]))
        x = x.reshape(B, G, L, n)
        cols = dev.from_numpy(_elements(rng, modulus, L, B * G * n)).reshape(L, B, n, G)
        cols = cols.permute(1, 3, 0, 2)                                   # [B, G, L, n], stride G
        for bitrev_in in (False, True):
            for xin in (x, cols):
                want = radix2.butterfly_ref(dev, xin, table, bitrev_in=bitrev_in)
                assert torch.equal(radix2.butterfly(dev, xin, table, bitrev_in=bitrev_in), want)
                out = torch.empty((G, L, B, n), dtype=torch.int32, device=device)
                radix2.butterfly(dev, xin, table, out=out.permute(2, 0, 1, 3), bitrev_in=bitrev_in)
                assert torch.equal(out.permute(2, 0, 1, 3), want)
                inplace = xin.clone()
                radix2.butterfly(dev, inplace, table, out=inplace, bitrev_in=bitrev_in)
                assert torch.equal(inplace, want)
        n *= 2


@ALL_FIELDS
def test_butterfly_kernel_column_tiles_equal_plain(device, modulus):
    """Kernel 8 on column views with many groups, where a block takes
    two neighbouring columns: column views in and out, both entries, in
    place."""
    from genstark_tpu_torch.field.limbs import power_series_mont_np
    from genstark_tpu_torch.ntt import radix2
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    L = dev.L
    rng = np.random.default_rng(modulus % 53)
    for n, G in ((64, 2048), (256, 1040), (512, 520), (1024, 264)):
        table = dev.from_numpy(power_series_mont_np(
            field.params, field.get_root_of_unity(n), n // 2))
        # column g is flat[j G + g]: x_g at j = 0, y_g at j = n/2
        flat = dev.from_numpy(edge_input(field, _elements(rng, modulus, L, G * n)))
        cols = flat.reshape(1, L, n, G).permute(0, 3, 1, 2)               # [1, G, L, n], stride G
        rows = flat.reshape(1, G, L, n)
        for bitrev_in in (False, True):
            for xin in (cols, rows):
                want = radix2.butterfly_ref(dev, xin, table, bitrev_in=bitrev_in)
                out = torch.empty((1, L, n, G), dtype=torch.int32, device=device)
                radix2.butterfly(dev, xin, table, out=out.permute(0, 3, 1, 2), bitrev_in=bitrev_in)
                assert torch.equal(out.permute(0, 3, 1, 2), want)
            want = radix2.butterfly_ref(dev, cols, table, bitrev_in=bitrev_in)
            assert torch.equal(radix2.butterfly(dev, cols, table, bitrev_in=bitrev_in), want)
            inplace = cols.clone(memory_format=torch.preserve_format)
            assert inplace.stride() == cols.stride()
            radix2.butterfly(dev, inplace, table, out=inplace, bitrev_in=bitrev_in)
            assert torch.equal(inplace, want)


@ALL_FIELDS
def test_bitrev_butterfly_kernel_equals_plain(device, modulus):
    """Kernel 8's bit-reversed entry over the 2048-point blocks of a
    2^13-point array, in place, every ordered pair of edge values at the first
    stage's butterflies."""
    from genstark_tpu_torch.field.limbs import power_series_mont_np
    from genstark_tpu_torch.ntt import radix2
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    n, local, L = 2 ** 13, 2048, dev.L
    rng = np.random.default_rng(modulus % 83)
    from genstark_tpu_torch.field.limbs import ints_to_limbs
    xs, ys = edge_pairs(field)
    x = _elements(rng, modulus, L, n)
    # bit-reversed input: the first stage pairs neighbours, so interleave
    x[:, :2 * len(xs)] = ints_to_limbs([v for pair in zip(xs, ys) for v in pair], L)
    x = dev.from_numpy(x).reshape(1, L, n)
    table = dev.from_numpy(power_series_mont_np(
        field.params, pow(field.get_root_of_unity(n), n // local, modulus), local // 2))
    view = lambda t: t.view(1, L, n // local, local).permute(0, 2, 1, 3)
    want = radix2.butterfly_ref(dev, view(x), table, bitrev_in=True)
    got = x.clone()
    radix2.butterfly(dev, view(got), table, out=view(got), bitrev_in=True)
    assert torch.equal(view(got), want)


def test_word_kernels_at_the_demo_field(device):
    """Kernels 8 and 5 at the demo-static field 96769 (L = 2: one word, p
    far below R = 2^32): local transforms of 2 .. 512 points (its largest
    power-of-two root), both entries, the ordered pairs of edge values at the
    first butterflies; mul, add and sub over every ordered pair and with 0,
    1 and p - 1 as a scalar on either side."""
    from genstark_tpu_torch.field.limbs import power_series_mont_np
    from genstark_tpu_torch.ntt import radix2
    modulus = 96769
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    assert dev.L == 2
    rng = np.random.default_rng(17)
    for log_n in range(1, 10):
        n = 1 << log_n
        table = dev.from_numpy(power_series_mont_np(field.params, field.get_root_of_unity(n),
                                                    n // 2))
        x = dev.from_numpy(np.stack([edge_input(field, _elements(rng, modulus, 2, n))
                                     for _ in range(6)]))
        x = x.reshape(2, 3, 2, n)
        for bitrev_in in (False, True):
            assert torch.equal(radix2.butterfly(dev, x, table, bitrev_in=bitrev_in),
                               radix2.butterfly_ref(dev, x, table, bitrev_in=bitrev_in))
    ab = dev.from_numpy(edge_input(field, _elements(rng, modulus, 2, 2 * 128)))
    ab = ab.reshape(2, 2, 128)
    a, b = ab[:, 0].contiguous(), ab[:, 1].contiguous()
    pairs = [(a, b)]
    for v in (0, 1, modulus - 1):
        k = dev.from_ints([v], to_mont=False)
        pairs += [(a, k), (k, a)]
    for pub, ref in ((dev.mont_mul, dev.mont_mul_ref), (dev._add, dev.add_ref),
                     (dev._sub, dev.sub_ref)):
        for x, y in pairs:
            assert torch.equal(pub(x, y), ref(x, y))


@ALL_FIELDS
def test_mont_chain_kernel_equals_plain(device, modulus):
    """Kernel 10's squaring chain, with the edge values (0, 1 and p - 1 among them)
    in the first columns."""
    from genstark_tpu_torch import roofline
    from genstark_tpu_torch.field.limbs import ints_to_limbs
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    x = _elements(np.random.default_rng(31), modulus, dev.L, 4096)
    edges = edge_values(field)
    x[:, :len(edges)] = ints_to_limbs(edges, dev.L)
    x = dev.from_numpy(x)
    assert torch.equal(roofline.mont_chain(dev, x, 5), roofline.mont_chain_ref(dev, x, 5))


def test_u32_chain_kernel_equals_plain(device):
    from genstark_tpu_torch import roofline
    rng = np.random.default_rng(37)
    x = torch.as_tensor(rng.integers(0, 1 << 32, size=(8, 2048), dtype=np.uint64)
                        .astype(np.uint32).view(np.int32), device=device)
    assert torch.equal(roofline.u32_chain(x), roofline.u32_chain_ref(x))
    one = x[0, :1].contiguous()      # the one-thread latency form
    assert torch.equal(roofline.u32_chain(one, 3), roofline.u32_chain_ref(one, 3))


def test_prime_field_device_is_the_card(device):
    """`PrimeField.device` is the card's DeviceField, and a proving context
    made in the JAX form takes it: its trace lies on the card and equals
    the explicit form's."""
    from genstark_tpu_torch import instantiate_script
    field = create_prime_field(P32)
    assert field.device is field.device_field("cuda")
    src = """
define Foo over prime field (2^32 - 3 * 2^25 + 1) {
    secret input startValue: element[1];
    transition 1 register {
        for each (startValue) {
            init { yield startValue; }
            for steps [1..63] { yield $r0 + 2; }
        }
    }
    enforce 1 constraint {
        for all steps { enforce transition($r) = $n; }
    }
}"""
    air = instantiate_script(src, {"extension_factor": 4}).air
    trace = air.init_proving_context([[1]]).generate_execution_trace()
    assert trace.device.type == "cuda"
    want = air.init_proving_context([[1]], dev=field.device_field("cpu"))
    assert torch.equal(trace.cpu(), want.generate_execution_trace())


@pytest.mark.parametrize("modulus", [P64, P256], ids=["p64", "p256"])
def test_direct_route_equals_four_step_on_card(device, modulus, monkeypatch):
    """A 2^14-point transform (R^-1 folded) through the direct route
    (kernels 8, 7, 5: one pass of the three stages m = 2048 .. 8192) equals
    the four-step route and the plain route."""
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.ntt import radix2
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    n = 2 ** 14
    args = (field, dev, n, field.get_root_of_unity(n), field.inv(field.params.R_mod % modulus))
    four = radix2.Radix2Plan(*args)
    monkeypatch.setattr(radix2, "DIRECT_ABOVE", 2 ** 13)
    direct = radix2.Radix2Plan(*args)
    assert (direct.route, four.route) == ("direct", "four_step")
    x = dev.from_numpy(_elements(np.random.default_rng(41), modulus, dev.L, 2 * n))
    x = x.reshape(dev.L, 2, n).permute(1, 0, 2)
    before = dict(kernels.launch_counts)
    got = radix2.transform(dev, x, direct)
    assert {k: kernels.launch_counts[k] - before[k]
            for k in ("butterfly", "bfly_stage", "bfly_stage_split")} == {
        "butterfly": 1, "bfly_stage": 1, "bfly_stage_split": 0}
    assert torch.equal(got, radix2.transform(dev, x, four))
    assert torch.equal(got, radix2.transform_ref(dev, x, direct))


# every limb count kernel 1 is built for
DFT_FIELDS = pytest.mark.parametrize(
    "modulus", [P32, GOLDILOCKS, SOLINAS96, P128, SOLINAS160, SOLINAS192, P224, P256],
    ids=["p32", "goldilocks", "p96", "p128", "p160", "p192", "p224", "p256"])


@DFT_FIELDS
@pytest.mark.parametrize("m", [2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("mode", ["none", "direct", "factored"])
def test_dft_level_kernel_inputs_and_modes(device, modulus, m, mode):
    """Kernel 1 (int8 tensor cores) at every level size the plans use, and
    m = 128 (two staged slices of j, four at L >= 10), with a ragged last
    column tile, in every twiddle mode: digits in and limbs in (the kernel
    encodes them), flat and as the transform's strided view, limbs and
    digits out; one launch each, equal to the plain level."""
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.ntt import dft
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    L, params = dev.L, field.params
    rest, cols = {"none": (1, 37), "direct": (4, 52), "factored": (16, 48)}[mode]
    root = field.get_root_of_unity(m * rest)
    w8 = torch.from_numpy(dft.w_digits(field, m, pow(root, rest, modulus), 5)).to(device)
    if mode == "none":
        tw = None
    elif mode == "direct":
        tw = {"p": dev.from_numpy(dft._direct_panel_np(params, root, m, rest, 2 * rest))}
    else:
        tw = {"a": dev.from_numpy(np.transpose(dft._panel_grid_np(
                  params, pow(root, 4, modulus), m, rest // 4), (2, 0, 1)).copy()),
              "b": dev.from_numpy(dft._panel_grid_np(params, root, m, 4))}
    rng = np.random.default_rng(m * 7 + rest)
    x = dev.from_numpy(_elements(rng, modulus, L, m * cols)).reshape(L, m, cols)
    x[:, 0, :3] = torch.as_tensor(_pm1(field, 3).astype(np.int32), device=device)
    digits = dft.encode_digits(x)
    pre = {1: 1, 4: 13, 16: 3}[rest]
    view = lambda t: t.reshape(t.shape[0], m, pre, cols // pre).permute(0, 2, 1, 3)
    for out_digits in (False, True):
        want = dft.run_dft_level_ref(dev, w8, digits, m, rest, tw, out_digits)
        for given in (digits, x, view(x), view(digits)):
            assert torch.equal(dft.run_dft_level_ref(dev, w8, given, m, rest, tw, out_digits),
                               want)
            before = kernels.launch_counts["dft_level"]
            got = dft.run_dft_level(dev, w8, given, m, rest, tw, out_digits)
            assert kernels.launch_counts["dft_level"] == before + 1
            assert torch.equal(got, want), (given.dtype, tuple(given.shape), out_digits)


@DFT_FIELDS
@pytest.mark.parametrize("n,count", [(2 ** 10, 5), (2 ** 12, 6)])
def test_dft_level_kernel_on_a_forced_five_level_chain(device, modulus, n, count, monkeypatch):
    """Kernel 1 at every level of a transform split into levels of 4
    (`ntt.MAX_LEVEL_BITS` lowered to 2): five levels at n = 2^10 and six at
    2^12, factored twiddles wherever rest > 4.  Each level is fed as the
    transform feeds it, the strided view [planes, pre, m, r] of the previous
    level's output, in both input forms (int32 limbs, which the kernel
    encodes, and int8 digit planes), limbs and digits out, against
    run_dft_level_ref; then the whole transform against the plain chain."""
    from genstark_tpu_torch import kernels, ntt
    from genstark_tpu_torch.ntt import DftPlan, dft
    monkeypatch.setattr(ntt, "MAX_LEVEL_BITS", 2)
    ntt.dft_levels.cache_clear()
    try:
        field = create_prime_field(modulus)
        dev = field.device_field(device)
        plan = DftPlan(field, dev, n, field.get_root_of_unity(n),
                       field.inv(field.params.R_mod % modulus))
    finally:
        ntt.dft_levels.cache_clear()
    assert plan.levels == (4,) * count
    assert sum(tw is not None and "a" in tw for tw in plan.tws) == count - 2   # rest > 4
    x = dev.from_numpy(_elements(np.random.default_rng(n), modulus, dev.L, n))
    limbs, pre, rest = x, 1, n
    for lvl, m in enumerate(plan.levels):
        rest //= m
        tw = plan.tws[lvl] if rest > 1 else None
        view = lambda t: t.reshape(t.shape[0], pre, m, rest)
        for given in (view(limbs), view(dft.encode_digits(limbs))):
            for out_digits in (False, True):
                args = (dev, plan.w8s[lvl], given, m, rest, tw, out_digits)
                assert torch.equal(kernels.dft_level(*args), dft.run_dft_level_ref(*args)), \
                    (lvl, given.dtype, out_digits)
        limbs = kernels.dft_level(dev, plan.w8s[lvl], view(limbs), m, rest, tw, False)
        limbs = limbs.reshape(dev.L, m * pre, rest)
        pre *= m
    got = ntt.transform(dev, x.reshape(1, dev.L, n), plan)
    monkeypatch.setattr(dft, "run_dft_level", dft.run_dft_level_ref)
    want = ntt.transform(dev, x.reshape(1, dev.L, n), plan)
    assert torch.equal(got, want)
    # the last level's [L, k_q, (k_q-1, ..., k_1)] is the transform's order
    assert torch.equal(limbs.reshape(dev.L, n), got[0])


def _tail_case(device, modulus, case):
    from genstark_tpu_torch.field.limbs import power_series_mont_np
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    p, L = field.modulus, dev.L
    # (Ne, s, ext, B, V, b_inc, ps_inc, with the incr table)
    Ne, s, ext, B, V, b_inc, ps_inc, with_incr = {
        "bench": (4096, 64, 16, 1, 2, True, True, True),
        "ragged": (903, 21, 7, 1, 2, True, True, True),     # Ne odd: no P-wide vectors
        "no_b": (2048, 32, 8, 0, 2, False, True, True),
        "no_incr": (2048, 64, 16, 2, 1, False, False, False),
        "s1_ext32": (2048, 1, 32, 1, 1, True, False, True),
        "s_ne_ext2": (1024, 1024, 2, 3, 2, False, True, True),
    }[case]
    rng = np.random.default_rng(Ne + B * 10 + V)
    rnd = lambda n: dev.from_numpy(_elements(rng, p, L, n))
    g = field.get_root_of_unity(2 ** (Ne - 1).bit_length())
    dom = (dev.from_numpy(power_series_mont_np(field.params, pow(g, s, p), Ne // s)),
           dev.from_numpy(power_series_mont_np(field.params, g, s)))
    h = pow(g, 3, p)
    incr = (dev.from_numpy(power_series_mont_np(field.params, pow(h, s, p), Ne // s)),
            dev.from_numpy(power_series_mont_np(field.params, h, s))) if with_incr else None
    b_stack = (torch.stack([rnd(Ne) for _ in range(B)]) if B else
               torch.empty((0, L, Ne), dtype=torch.int32, device=device))
    e_std = torch.stack([rnd(Ne) for _ in range(V)])
    qe = rnd(Ne)
    qe[:, :2] = torch.as_tensor(_pm1(field, 2).astype(np.int32), device=device)
    return (dev, qe, b_stack, e_std, dom, incr, rnd(ext), p - 12345,
            rnd(B * (2 if b_inc else 1)), rnd(V * (2 if ps_inc else 1)), b_inc, ps_inc, ext)


@ALL_FIELDS
@pytest.mark.parametrize("case", ["bench", "ragged", "no_b", "no_incr", "s1_ext32",
                                  "s_ne_ext2"])
def test_lcomb_tail_kernel_cases(device, modulus, case):
    """Kernel 4 (word product) at every L: the bench's B = 1, V = 2 with
    both raised copies; Ne odd, so no thread's positions form a vector; B =
    0; no incr table; s = 1 with ext = 32; s = Ne with ext = 2.  One launch
    each, equal to the plain tail."""
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.protocol.lincomb_kernel import lcomb_tail, lcomb_tail_ref
    args = _tail_case(device, modulus, case)
    before = kernels.launch_counts["lcomb_tail"]
    got = lcomb_tail(*args)
    assert kernels.launch_counts["lcomb_tail"] == before + 1
    assert torch.equal(got, lcomb_tail_ref(*args))


@ALL_FIELDS
def test_mont_inv_kernel_equals_plain(device, modulus):
    """Kernel A against mont_pow_ref(x, p - 2): one element (inv's use) and
    300, zero, one and p - 1 among them; one launch a call."""
    from genstark_tpu_torch import kernels
    field = create_prime_field(modulus)
    dev = field.device_field(device)
    rng = np.random.default_rng(modulus % 211)
    a = _elements(rng, modulus, dev.L, 300)
    a[:, 7] = 0
    x = dev.from_numpy(a)
    x[:, 8:9] = dev.one((1,))
    x[:, 9:11] = torch.as_tensor(_pm1(field, 2).astype(np.int32), device=device)
    for xin in (x[:, :1], x, x[:, 7:8]):
        before = kernels.launch_counts["mont_inv"]
        got = kernels.mont_inv(dev, xin)
        assert kernels.launch_counts["mont_inv"] == before + 1
        assert torch.equal(got, dev.mont_pow_ref(xin, field.modulus - 2))


def _odd_hex_roots(rng, n):
    """Roots whose state sha256(root) begins with a zero nibble (the state's
    hex length is odd or short), as int32 [n, 8] LE words."""
    import hashlib
    out = []
    while len(out) < n:
        root = rng.integers(0, 256, size=32, dtype=np.uint8).tobytes()
        if hashlib.sha256(root).digest()[0] < 16:
            out.append(np.frombuffer(root, dtype="<u4").view(np.int32))
    return np.stack(out)


def test_sample_queries_spans_two_windows(device):
    """Kernel B on odd-hex states whose sets need more candidates than one
    window of 256 (found on the host with testing.candidates_needed):
    equal to sample_sets_ref and the host sampler."""
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.protocol import device_queries as dq
    from genstark_tpu_torch.protocol.queries import get_pseudorandom_indexes
    rng = np.random.default_rng(29)
    specs = [(48, 1 << 17, 16, 32 * 48 + 512), (24, 1 << 13, 16, 32 * 24 + 512)]
    roots_np = np.concatenate([testing.odd_hex_roots(rng, 1, *spec[:3]) for spec in specs])
    roots = torch.as_tensor(roots_np, device=device)
    before = kernels.launch_counts["sample_queries"]
    idx, found = kernels.sample_queries(roots, specs)
    assert kernels.launch_counts["sample_queries"] == before + 1
    want_idx, want_found = dq.sample_sets_ref(roots, specs)
    assert torch.equal(idx, want_idx) and torch.equal(found, want_found)
    for s, (count, max_, excl, _) in enumerate(specs):
        seed = roots_np[s].view("<u4").tobytes()
        assert testing.candidates_needed(seed, count, max_, excl) > 256
        assert idx[s, :count].tolist() == get_pseudorandom_indexes(seed, count, max_, excl)


def test_sample_queries_kernel_equals_plain(device):
    """Kernel B against sample_sets_ref: the bench's sets (48 over 2^17,
    24 over each layer's column length, multiples of 16 excluded), a set
    over 2^32 (indexes above 2^31), one with no exclusion, one whose
    window runs out, and odd-hex states; and against the host sampler."""
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.protocol import device_queries as dq
    from genstark_tpu_torch.protocol.queries import get_pseudorandom_indexes
    rng = np.random.default_rng(17)
    specs = ([(48, 1 << 17, 16, 32 * 48 + 512)]
             + [(24, 1 << k, 16, 32 * 24 + 512) for k in (15, 13, 11, 9)]
             + [(24, 1 << 32, 16, 32 * 24 + 512), (8, 1 << 8, 0, 768), (48, 1 << 17, 16, 8)]
             + [(16, 1 << 12, 4, 1024)] * 3)
    roots_np = np.concatenate([
        rng.integers(-2 ** 31, 2 ** 31, size=(8, 8), dtype=np.int64).astype(np.int32),
        _odd_hex_roots(rng, 3)])
    roots = torch.as_tensor(roots_np, device=device)
    before = kernels.launch_counts["sample_queries"]
    idx, found = kernels.sample_queries(roots, specs)
    assert kernels.launch_counts["sample_queries"] == before + 1
    want_idx, want_found = dq.sample_sets_ref(roots, specs)
    assert torch.equal(idx, want_idx) and torch.equal(found, want_found)
    assert int(found[7]) < 48 and bool((idx[5] >= 1 << 31).any())
    for s, (count, max_, excl, _) in enumerate(specs):
        if s != 7:
            seed = roots_np[s].view("<u4").tobytes()
            assert idx[s, :count].tolist() == get_pseudorandom_indexes(seed, count, max_, excl)
