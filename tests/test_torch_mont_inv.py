"""A word-level model of kernel A (`genstark_tpu_torch/csrc/field_ops.cu`
mont_inv_kernel: Pornin's optimized binary GCD, IACR ePrint 2020/972) in
Python, against `pow` and the kernel's plain version `mont_pow_ref(x, p - 2)`.

The model follows the kernel's steps on 32-bit words: the 64-bit
approximations of a and b (`gcd_approx`), `kernels.GCD_STEPS` (30) steps a
batch with signed 32-bit factors, the four updates of a batch as the quad of
lanes computes them (`gcd_lane_update`: a signed combination on K + 1 two's
complement words, shifted by 30 for a and b, reduced by one Montgomery word
for u and v, whose signs follow a's and b's), and the last word product by
the host constant of `kernels.mont_inv_constant`.  It checks the bounds the
kernel relies on (factors |f| + |g| <= 2^30, exact shifts, values below 2p
before the conditional subtraction, b = 1 after T batches) at every field,
zero, one, p - 1 and powers of two included.  The kernel itself runs only
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest

from genstark_tpu_torch import kernels
from genstark_tpu_torch.field import P32, P64, P128, P224, P256, create_prime_field
from genstark_tpu_torch.testing import SOLINAS96, SOLINAS160, SOLINAS192

M32 = 0xFFFFFFFF
STEPS = kernels.GCD_STEPS
FIELDS = [P32, P64, P128, P224, P256, 96769]
IDS = ["p32", "p64", "p128", "p224", "p256", "p96769"]
# K = 3, 5 and 6 words (L = 6, 10, 12)
MID = [SOLINAS96, SOLINAS160, SOLINAS192]
MID_IDS = ["p96", "p160", "p192"]


def _words(v, k):
    return [(v >> (32 * w)) & M32 for w in range(k)]


def _value(words):
    return sum(w << (32 * i) for i, w in enumerate(words))


def gcd_approx(x, s):
    """(x mod 2^31) + 2^31 floor(x / 2^s) from the words at s >> 5 and the next."""
    q, r = s >> 5, s & 31
    lo = x[q] if q < len(x) else 0
    hi = x[q + 1] if q + 1 < len(x) else 0
    top = ((hi << 32) | lo) >> r
    assert top < 1 << 33
    return (x[0] & 0x7FFFFFFF) | (top << 31)


def gcd_mul_signed(x, f):
    k, m = len(x), abs(f)
    assert m <= 1 << STEPS
    out, c = [], 0
    for w in range(k):
        c += x[w] * m
        out.append(c & M32)
        c >>= 32
    out.append(c & M32)
    if f < 0:
        c = 1
        for w in range(k + 1):
            c += ~out[w] & M32
            out[w] = c & M32
            c >>= 32
    return out


def gcd_lane_update(q, a, b, u, v, f, g, p_words, n0):
    """Lane q's update: t = x f + y g on K + 1 two's complement words ((x, y)
    = (a, b) for q < 2, (u, v) else); q < 2: |t| / 2^STEPS; q >= 2: t 2^-32
    mod p by one Montgomery word on the signed t.  Returns (out, t < 0)."""
    k = len(a)
    x, y = (a, b) if q < 2 else (u, v)
    px, py = gcd_mul_signed(x, f), gcd_mul_signed(y, g)
    t, c = [], 0
    for w in range(k + 1):
        c += px[w] + py[w]
        t.append(c & M32)
        c >>= 32
    neg = t[k] >> 31 != 0
    want = _value(x) * f + _value(y) * g
    if q < 2:
        out = [((t[w] >> STEPS) | (t[w + 1] << (32 - STEPS))) & M32 for w in range(k)]
        if neg:
            c = 1
            for w in range(k):
                c += ~out[w] & M32
                out[w] = c & M32
                c >>= 32
        assert want % (1 << STEPS) == 0 and _value(out) == abs(want) >> STEPS
        return out, neg
    p = _value(p_words)
    m = t[0] * n0 & M32
    c = (m * p_words[0] + t[0]) >> 32
    r = []
    for w in range(1, k):
        c += m * p_words[w] + t[w]
        assert c < 1 << 64
        r.append(c & M32)
        c >>= 32
    c += t[k]
    r.append(c & M32)
    hi = ((c >> 32) + (M32 if neg else 0)) & M32
    s_value = _value(r) + (-(1 << (32 * k)) if hi == M32 else hi << (32 * k))
    assert s_value * (1 << 32) == want + m * p and -p // 4 <= s_value < 5 * p // 4
    return _words(s_value % p, k), neg


def model_inv(x, p, L):
    """The kernel's steps for one Montgomery element x = a R: a^-1 R."""
    k = L // 2
    n0 = -pow(p, -1, 1 << 32) % (1 << 32)
    p_words = _words(p, k)
    batches, c = kernels.mont_inv_constant(p, L)
    a, b, u, v = _words(x, k), list(p_words), _words(1, k), _words(0, k)
    for _ in range(batches):
        length = max(64, max(((a[w] | b[w]).bit_length() + 32 * w) if a[w] | b[w] else 0
                             for w in range(k)))
        ab, bb = gcd_approx(a, length - 33), gcd_approx(b, length - 33)
        f0, g0, f1, g1 = 1, 0, 0, 1
        for _ in range(STEPS):
            odd = ab & 1
            swap = odd and ab < bb
            d, e, df, dg = (ab - bb) % (1 << 64), (bb - ab) % (1 << 64), f0 - f1, g0 - g1
            bb, ab = (ab if swap else bb), (((e if swap else d) if odd else ab) >> 1)
            nf1, ng1 = (f0, g0) if swap else (f1, g1)
            f0, g0 = ((-df, -dg) if swap else (df, dg)) if odd else (f0, g0)
            f1, g1 = 2 * nf1, 2 * ng1
        assert abs(f0) + abs(g0) <= 1 << STEPS and abs(f1) + abs(g1) <= 1 << STEPS
        assert all(-2 ** 31 <= q < 2 ** 31 for q in (f0, g0, f1, g1))   # int32
        # the quad: lanes 0-3 give a, b, u, v; u and v flip sign where a and b did
        r = [gcd_lane_update(q, a, b, u, v, f1 if q & 1 else f0, g1 if q & 1 else g0,
                             p_words, n0) for q in range(4)]
        p = _value(p_words)
        a, b = r[0][0], r[1][0]
        u, v = [_words(-_value(r[q][0]) % p if r[q & 1][1] else _value(r[q][0]), k)
                for q in (2, 3)]
    if x:
        assert _value(a) == 0 and _value(b) == 1
        assert _value(v) == pow(x, -1, p) * pow(2, (STEPS - 32) * batches, p) % p
    R = 1 << (16 * L)
    return _value(v) * _value([int(w) for w in c]) * pow(R, -1, p) % p


@pytest.mark.parametrize("modulus", FIELDS + MID, ids=IDS + MID_IDS)
def test_binary_gcd_model_equals_the_plain_inverse(modulus):
    field = create_prime_field(modulus)
    p, L = field.modulus, field.params.L
    rng = np.random.default_rng(modulus % 9973)
    values = [0, 1, 2, p - 1, p - 2, (p - 1) // 2]
    values += [1 << e for e in range(0, p.bit_length() - 1, 7)]
    values += [int.from_bytes(rng.bytes(32), "little") % p for _ in range(24)]
    R = 1 << (16 * L)
    got = [model_inv(v * R % p, p, L) for v in values]
    assert got == [pow(v, p - 2, p) * R % p for v in values]
    dev = field.device_field("cpu")
    x = dev.from_ints(values)
    assert dev.to_ints(dev.mont_pow_ref(x, p - 2), from_mont=False) == got


def test_mont_inv_constant():
    """T = ceil((2 len(p) - 1) / 30) batches (18 at p256) and c = 2^2T R^3."""
    assert [kernels.mont_inv_constant(p, create_prime_field(p).params.L)[0]
            for p in FIELDS] == [3, 5, 9, 15, 18, 2]
    T, c = kernels.mont_inv_constant(P128, 8)
    assert c.dtype == np.uint32 and c.shape == (4,)
    assert _value([int(w) for w in c]) == pow(2, 2 * T, P128) * pow(1 << 128, 3, P128) % P128
