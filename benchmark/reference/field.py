"""Prime-field arithmetic over Python ints for the plain reference.

Polynomials are coefficient lists, lowest degree first.  The domain
generator is the protocol's: the first g = 2, 3, ... whose image
g^((p-1)/2^s) has exact order 2^s, s the two-adicity of p - 1.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence


class Field:
    def __init__(self, modulus: int):
        self.p = modulus
        n, s = modulus - 1, 0
        while n % 2 == 0:
            n //= 2
            s += 1
        self.two_adicity = s
        g = 2
        while True:
            h = pow(g, (modulus - 1) >> s, modulus)
            if pow(h, 1 << (s - 1), modulus) == modulus - 1:
                break
            g += 1
        self.generator = h
        # bytes of one serialized element: the modulus's 32-bit words times 4
        self.element_size = max(1, (modulus.bit_length() + 31) // 32) * 4

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError("inverse of zero")
        return pow(a, self.p - 2, self.p)

    def batch_inv(self, values: Sequence[int]) -> List[int]:
        p = self.p
        prefix, acc = [], 1
        for v in values:
            if v % p == 0:
                raise ZeroDivisionError("inverse of zero")
            prefix.append(acc)
            acc = acc * v % p
        inv_acc = pow(acc, p - 2, p)
        out = [0] * len(values)
        for i in range(len(values) - 1, -1, -1):
            out[i] = prefix[i] * inv_acc % p
            inv_acc = inv_acc * values[i] % p
        return out

    def root_of_unity(self, n: int) -> int:
        k = n.bit_length() - 1
        if n != 1 << k or k > self.two_adicity:
            raise ValueError(f"no root of unity of order {n}")
        return pow(self.generator, 1 << (self.two_adicity - k), self.p)

    def eval_poly(self, poly: Sequence[int], x: int) -> int:
        acc = 0
        for c in reversed(poly):
            acc = (acc * x + c) % self.p
        return acc

    def mul_polys(self, a: Sequence[int], b: Sequence[int]) -> List[int]:
        out = [0] * (len(a) + len(b) - 1)
        for i, ai in enumerate(a):
            for j, bj in enumerate(b):
                out[i + j] = (out[i + j] + ai * bj) % self.p
        return out

    def interpolate(self, xs: Sequence[int], ys: Sequence[int]) -> List[int]:
        """Lagrange interpolation through (xs, ys)."""
        p, n = self.p, len(xs)
        root = [1]
        for x in xs:
            root = self.mul_polys(root, [(-x) % p, 1])
        nums = []
        for x in xs:                       # root / (X - x) by synthetic division
            out, carry = [0] * n, 0
            for i in range(n, 0, -1):
                carry = (root[i] + carry * x) % p
                out[i - 1] = carry
            nums.append(out)
        inv_d = self.batch_inv([self.eval_poly(nums[i], xs[i]) for i in range(n)])
        coeffs = [0] * n
        for i in range(n):
            c = ys[i] * inv_d[i] % p
            for j in range(n):
                coeffs[j] = (coeffs[j] + nums[i][j] * c) % p
        return coeffs

    def interpolate_roots(self, ys: Sequence[int]) -> List[int]:
        """Coefficients of the polynomial through ys over the n-th roots of
        unity (an inverse NTT, n = len(ys))."""
        n = len(ys)
        coeffs = _ntt(list(ys), self.inv(self.root_of_unity(n)), self.p)
        n_inv = self.inv(n)
        return [c * n_inv % self.p for c in coeffs]

    def prng(self, seed: bytes, count: int) -> List[int]:
        """The transcript's sha256-counter stream: state = sha256(seed),
        v_i = int_be(sha256(state || u64_be(i))) mod p."""
        state = hashlib.sha256(seed).digest()
        return [int.from_bytes(hashlib.sha256(state + i.to_bytes(8, "big")).digest(), "big")
                % self.p for i in range(count)]


def _ntt(values: List[int], w: int, p: int) -> List[int]:
    n = len(values)
    if n == 1:
        return values
    even = _ntt(values[0::2], w * w % p, p)
    odd = _ntt(values[1::2], w * w % p, p)
    out, wk = [0] * n, 1
    for k in range(n // 2):
        t = wk * odd[k] % p
        out[k] = (even[k] + t) % p
        out[k + n // 2] = (even[k] - t) % p
        wk = wk * w % p
    return out
