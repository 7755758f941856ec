"""A word-level model of the kernels' 32-bit-word Montgomery product
(`genstark_tpu_torch/csrc/field.cuh`: mont_mul_w, add_mod_w, sub_mod_w,
load_elem_w / store_elem_w) in numpy, against Python integers.

The model runs the header's exact instruction sequence, one PTX instruction
at a time with its carry flag (mad.lo.cc / madc.lo.cc / mad.hi.cc /
madc.hi.cc / addc.cc / addc / sub.cc / subc.cc / subc), in numpy uint64
with 32-bit masks over vectors of elements.  The kernels themselves run only
on the card (tests/test_torch_cuda.py); this pins the schedule, its carry
bounds and its canonical output on the CPU.
"""

import numpy as np
import pytest

from genstark_tpu_torch.field import P32, P64, P128, P224, P256, create_prime_field

MASK = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)
FIELDS = pytest.mark.parametrize("modulus", [P32, P64, P128, P224, P256],
                                 ids=["p32", "p64", "p128", "p224", "p256"])


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
