"""A word-level model of the kernels' 32-bit-word Montgomery product
(`genstark_tpu_torch/csrc/field.cuh`: mont_mul_w, add_mod_w, sub_mod_w,
load_elem_w / store_elem_w) in numpy, against Python integers, and of the
butterfly that kernels 7/9 and 8 build on it against the plain transform.

The model runs the header's exact instruction sequence, one PTX instruction
at a time with its carry flag (mad.lo.cc / madc.lo.cc / mad.hi.cc /
madc.hi.cc / addc.cc / addc / sub.cc / subc.cc / subc), in numpy uint64
with 32-bit masks over vectors of elements.  The kernels themselves run only
on the card (tests/test_torch_cuda.py); this pins the schedule, its carry
bounds and its canonical output on the CPU.  Numpy and torch on the CPU
only: no JAX.
"""

import os
import re

import numpy as np
import pytest
import torch

from genstark_tpu_torch.field import P32, P64, P128, P224, P256, create_prime_field

MASK = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)
# the demo-static field (L = 2: one word, p < 2^17 far below R = 2^32)
DEMO = 96769
FIELDS = pytest.mark.parametrize("modulus", [DEMO, P32, P64, P128, P224, P256],
                                 ids=["p96769", "p32", "p64", "p128", "p224", "p256"])
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "genstark_tpu_torch", "csrc")


class Ptx:
    """The carry flag and the u32 carry-chain instructions field.cuh uses."""

    def __init__(self, n):
        self.cf = np.zeros(n, dtype=np.uint64)

    def _out(self, r, cc):
        if cc:
            self.cf = r >> S32
        return r & MASK

    def mad_lo(self, a, b, c, carry_in=False, cc=True):
        return self._out(((a * b) & MASK) + c + (self.cf if carry_in else 0), cc)

    def mad_hi(self, a, b, c, carry_in=False, cc=True):
        return self._out(((a * b) >> S32) + c + (self.cf if carry_in else 0), cc)

    def add(self, a, b, carry_in=False, cc=True):
        return self._out(a + b + (self.cf if carry_in else 0), cc)

    def sub(self, a, b, borrow_in=False, cc=True):
        # a - b - borrow as a 33-bit two's-complement value: the flag is the borrow
        r = (a | (np.uint64(1) << S32)) - b - (self.cf if borrow_in else 0)
        if cc:
            self.cf = np.uint64(1) - (r >> S32)
        return r & MASK


def cond_sub_p_w(ptx, t, hi, p):
    K = len(p)
    d = [ptx.sub(t[0], p[0])] + [ptx.sub(t[j], p[j], borrow_in=True) for j in range(1, K)]
    top = ptx.sub(hi, np.uint64(0), borrow_in=True, cc=False)
    keep = top == MASK
    return [np.where(keep, t[j], d[j]) for j in range(K)]


def mont_mul_w(a, b, p, n0):
    """field.cuh mont_mul_w<K>, instruction for instruction."""
    K = len(p)
    n = a[0].shape[0]
    ptx = Ptx(n)
    zero = np.zeros(n, dtype=np.uint64)
    t = [zero.copy() for _ in range(K + 2)]
    for i in range(K):
        bi = b[i]
        t[0] = ptx.mad_lo(a[0], bi, t[0])
        for j in range(1, K):
            t[j] = ptx.mad_lo(a[j], bi, t[j], carry_in=True)
        t[K] = ptx.add(t[K], zero, carry_in=True)
        t[K + 1] = ptx.add(t[K + 1], zero, carry_in=True, cc=False)
        t[1] = ptx.mad_hi(a[0], bi, t[1])
        for j in range(1, K):
            t[j + 1] = ptx.mad_hi(a[j], bi, t[j + 1], carry_in=True)
        t[K + 1] = ptx.add(t[K + 1], zero, carry_in=True, cc=False)

        m = (t[0] * n0) & MASK
        t[0] = ptx.mad_lo(m, p[0], t[0])
        assert not t[0].any()
        for j in range(1, K):
            t[j] = ptx.mad_lo(m, p[j], t[j], carry_in=True)
        t[K] = ptx.add(t[K], zero, carry_in=True)
        t[K + 1] = ptx.add(t[K + 1], zero, carry_in=True, cc=False)
        t[1] = ptx.mad_hi(m, p[0], t[1])
        for j in range(1, K):
            t[j + 1] = ptx.mad_hi(m, p[j], t[j + 1], carry_in=True)
        t[K + 1] = ptx.add(t[K + 1], zero, carry_in=True, cc=False)
        t = t[1:] + [zero.copy()]
    assert (t[K] <= 1).all()
    return cond_sub_p_w(ptx, t[:K], t[K], p)


def add_mod_w(a, b, p):
    K = len(p)
    ptx = Ptx(a[0].shape[0])
    s = [ptx.add(a[0], b[0])] + [ptx.add(a[j], b[j], carry_in=True) for j in range(1, K)]
    hi = ptx.add(np.uint64(0), np.uint64(0), carry_in=True, cc=False)
    return cond_sub_p_w(ptx, s, hi, p)


def sub_mod_w(a, b, p):
    K = len(p)
    ptx = Ptx(a[0].shape[0])
    d = [ptx.sub(a[0], b[0])] + [ptx.sub(a[j], b[j], borrow_in=True) for j in range(1, K)]
    mask = ptx.sub(np.uint64(0), np.uint64(0), borrow_in=True, cc=False)
    return [ptx.add(d[0], p[0] & mask)] + [ptx.add(d[j], p[j] & mask, carry_in=True)
                                           for j in range(1, K)]


def to_words(values, K):
    return [np.array([(v >> (32 * w)) & 0xFFFFFFFF for v in values], dtype=np.uint64)
            for w in range(K)]


def from_words(words):
    return [sum(int(words[w][i]) << (32 * w) for w in range(len(words)))
            for i in range(len(words[0]))]


def _values(modulus, n, seed):
    params = create_prime_field(modulus).params
    rng = np.random.default_rng(seed)
    edges = [0, 1, 2, modulus - 1, modulus - 2, params.R_mod, modulus >> 1]
    rand = [int.from_bytes(rng.bytes(params.element_size + 8), "little") % modulus
            for _ in range(n)]
    return edges + rand


@FIELDS
def test_word_product_schedule_equals_integers(modulus):
    params = create_prime_field(modulus).params
    K = params.L // 2
    R_inv = pow(params.R, -1, modulus)
    xs = _values(modulus, 200, seed=modulus % 1009)
    ys = list(reversed(_values(modulus, 200, seed=modulus % 1013)))
    pairs = [(x, y) for x in xs[:7] for y in xs[:7]] + list(zip(xs, ys))
    a = to_words([x for x, _ in pairs], K)
    b = to_words([y for _, y in pairs], K)
    p = to_words([modulus], K)
    got = from_words(mont_mul_w(a, b, p, np.uint64(params.n0p32)))
    assert got == [x * y * R_inv % modulus for x, y in pairs]


@FIELDS
def test_word_add_sub_equal_integers(modulus):
    params = create_prime_field(modulus).params
    K = params.L // 2
    xs = _values(modulus, 100, seed=3)
    ys = list(reversed(_values(modulus, 100, seed=4)))
    pairs = [(x, y) for x in xs[:7] for y in xs[:7]] + list(zip(xs, ys))
    a = to_words([x for x, _ in pairs], K)
    b = to_words([y for _, y in pairs], K)
    p = to_words([modulus], K)
    assert from_words(add_mod_w(a, b, p)) == [(x + y) % modulus for x, y in pairs]
    assert from_words(sub_mod_w(a, b, p)) == [(x - y) % modulus for x, y in pairs]


@FIELDS
def test_word_radix_is_the_limb_radix(modulus):
    """R = 2^(32K) = 2^(16L): every Montgomery table of the port holds for
    the word product."""
    params = create_prime_field(modulus).params
    assert params.L % 2 == 0
    assert 1 << (32 * (params.L // 2)) == params.R


@FIELDS
def test_limb_word_pack_round_trip(modulus):
    """load_elem_w packs limbs (2w, 2w+1) of a limb-major array into word
    w; store_elem_w unpacks them again."""
    from genstark_tpu_torch.field.limbs import ints_to_limbs, limbs_to_ints
    params = create_prime_field(modulus).params
    K = params.L // 2
    values = _values(modulus, 64, seed=5)
    limbs = ints_to_limbs(values, params.L).astype(np.uint64)       # [L, n]
    words = [limbs[2 * w] | (limbs[2 * w + 1] << np.uint64(16)) for w in range(K)]
    assert from_words(words) == values
    back = np.stack([(words[t // 2] >> np.uint64(16 * (t % 2))) & np.uint64(0xFFFF)
                     for t in range(params.L)])
    assert np.array_equal(back, limbs)
    assert limbs_to_ints(back.astype(np.uint32)) == values


@FIELDS
def test_n0p32(modulus):
    params = create_prime_field(modulus).params
    assert (modulus * params.n0p32) % (1 << 32) == (1 << 32) - 1
    assert params.n0p32 % (1 << 16) == params.n0p


@FIELDS
def test_word_product_takes_an_operand_below_R(modulus):
    """a < R = 2^(32K) non-canonical, b < p: the product stays below 2p
    before its subtraction, so the output is canonical (the digest chunks
    of fiat_shamir.digest_words_to_field_mont)."""
    params = create_prime_field(modulus).params
    K = params.L // 2
    R_inv = pow(params.R, -1, modulus)
    rng = np.random.default_rng(modulus % 997)
    big = [params.R - 1, params.R - 2, modulus, modulus + 1, params.R - modulus] + [
        int.from_bytes(rng.bytes(4 * K), "little") for _ in range(60)]
    bs = _values(modulus, len(big) - 7, seed=11)
    a, b = to_words(big, K), to_words(bs, K)
    p = to_words([modulus], K)
    got = from_words(mont_mul_w(a, b, p, np.uint64(params.n0p32)))
    assert got == [x * y * R_inv % modulus for x, y in zip(big, bs)]


def pack(limbs):
    """load_elem_w: limbs [L, n] (uint64) -> K word vectors."""
    return [limbs[2 * w] | (limbs[2 * w + 1] << np.uint64(16)) for w in range(len(limbs) // 2)]


def unpack(words):
    """store_elem_w: K word vectors -> limbs [L, n]."""
    return np.stack([(words[t // 2] >> np.uint64(16 * (t % 2))) & np.uint64(0xFFFF)
                     for t in range(2 * len(words))])


def butterfly_transform(x, table, p, n0):
    """Kernel 8's local transform on the word model: x limbs [L, n] in
    natural order, bit-reversed, then the radix-2 DIT stages; each
    butterfly packs its limbs and the twiddle's (table [L, n/2], the root's
    powers), runs mont_mul_w, add_mod_w, sub_mod_w and unpacks."""
    L, n = x.shape
    log_n = n.bit_length() - 1
    rev = [int(format(j, f"0{log_n}b")[::-1], 2) if log_n else 0 for j in range(n)]
    a = x.astype(np.uint64)[:, rev]
    tw = table.astype(np.uint64)
    m = 1
    while m < n:
        k = np.arange(n // 2)
        r = k & (m - 1)
        i0 = ((k // m) * 2 * m) + r
        w = pack(tw[:, r * (n // (2 * m))])
        v = mont_mul_w(pack(a[:, i0 + m]), w, p, n0)
        u = pack(a[:, i0])
        a[:, i0] = unpack(add_mod_w(u, v, p))
        a[:, i0 + m] = unpack(sub_mod_w(u, v, p))
        m *= 2
    return a


@FIELDS
def test_word_butterfly_equals_plain_transform(modulus):
    """The butterfly of kernels 7/9 and 8 on the word model (pack the limbs,
    mont_mul_w, add_mod_w, sub_mod_w, unpack) against radix2.butterfly_ref,
    one 128-point transform with every ordered pair of edge values at the
    first stage's butterflies (natural j and j + n/2)."""
    from genstark_tpu_torch.field.limbs import ints_to_limbs, power_series_mont_np
    from genstark_tpu_torch.ntt import radix2
    field = create_prime_field(modulus)
    params = field.params
    L, K = params.L, params.L // 2
    n = 128
    edges = _values(modulus, 0, seed=0)
    rand = _values(modulus, n, seed=7)[len(edges):]
    xs = [e for e in edges for _ in edges]
    ys = [e for _ in edges for e in edges]
    x = ints_to_limbs(xs + rand[:n // 2 - len(xs)] + ys + rand[n // 2:n - len(ys)], L)
    assert x.shape == (L, n)
    table = power_series_mont_np(params, field.get_root_of_unity(n), n // 2)
    got = butterfly_transform(x, table, to_words([modulus], K), np.uint64(params.n0p32))
    dev = field.device_field("cpu")
    want = radix2.butterfly_ref(dev, dev.from_numpy(x).reshape(1, 1, L, n),
                                dev.from_numpy(table))
    assert np.array_equal(got, dev.to_numpy(want.reshape(L, n)).astype(np.uint64))


@FIELDS
def test_field_words_are_p_limbs_and_n0(modulus):
    """kernels._field_words: the p limbs, then n0' = -p^-1 mod 2^32, L + 1
    words; field.cuh fieldw_from_words packs the limbs into p's words."""
    from genstark_tpu_torch import kernels
    dev = create_prime_field(modulus).device_field("cpu")
    L = dev.L
    words = kernels._field_words(dev)
    assert words.dtype == np.uint32 and words.shape == (L + 1,)
    p_words = [int(words[2 * w]) | int(words[2 * w + 1]) << 16 for w in range(L // 2)]
    assert sum(v << (32 * w) for w, v in enumerate(p_words)) == modulus
    assert int(words[L]) == dev.params.n0p32


def _csrc():
    return {name: open(os.path.join(CSRC, name)).read() for name in sorted(os.listdir(CSRC))}


FORBIDDEN = (r"\bstruct\s+Field\b(?!W)", r"\bfield_from_words\b", r"\bmont_mul\s*<",
             r"\badd_mod\s*<", r"\bsub_mod\s*<", r"\bcond_sub_p\s*<", r"\bload_elem\s*<",
             r"\bstore_elem\s*<")


@pytest.mark.parametrize("pattern", FORBIDDEN)
def test_csrc_holds_one_product(pattern):
    """No CUDA source declares or calls the 16-bit-limb product (field.cuh's
    word product is the only one): no `struct Field`, no field_from_words,
    no mont_mul / add_mod / sub_mod / cond_sub_p / load_elem / store_elem
    template (their `_w` forms are the product)."""
    hits = [(name, m.group(0)) for name, text in _csrc().items()
            for m in re.finditer(pattern, text)]
    assert not hits


def test_field_kernels_call_the_word_product():
    """Kernels 5, 7/9, 8 and 10 call mont_mul_w, add_mod_w and sub_mod_w
    (kernel 10 the product alone) and read the host's words with
    fieldw_from_words."""
    src = _csrc()
    for name, calls in (("field_ops.cu", ("mont_mul_w<", "add_mod_w<", "sub_mod_w<")),
                        ("butterfly.cu", ("mont_mul_w<", "add_mod_w<", "sub_mod_w<")),
                        ("butterfly_stage.cu", ("mont_mul_w<", "add_mod_w<", "sub_mod_w<")),
                        ("probes.cu", ("mont_mul_w<",))):
        assert all(c in src[name] for c in calls), name
        assert "fieldw_from_words(field_words, L)" in src[name], name
    assert "int general" not in src["probes.cu"]


@pytest.mark.parametrize("name", ["butterfly.cu", "butterfly_stage.cu", "field_ops.cu"])
def test_word_kernels_pack_limbs_through_field_cuh(name):
    """Kernels 5, 6, A, 7/9 and 8 pack limbs into words and back only
    through field.cuh (limb_pair, load_elem_w, store_elem_w, on device
    memory and on shared-memory tiles): no limb shifted by 16 and no
    16-bit mask of their own."""
    text = _csrc()[name]
    assert not re.findall(r"<<\s*16\b|&\s*0xFFFFu\b", text)
    assert "load_elem_w<K>(" in text and "store_elem_w<K>(" in text
