"""Host-side (python int) prime-field arithmetic.

Counterpart of ``genstark_tpu/field/host.py`` (a copy).  It is the
execution path for all *small* computations in the protocol:
boundary-constraint interpolants, FRI remainder checks, verifier point
evaluations, Fiat-Shamir derivations (``prng``), table seeds.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import List, Sequence


class HostField:
    """Prime field arithmetic over python ints. Polynomials are coefficient
    lists, lowest degree first (matching galois's coefficient-form ops)."""

    def __init__(self, modulus: int):
        self.p = modulus

    # ----- scalar ops -------------------------------------------------------
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def div(self, a: int, b: int) -> int:
        return (a * self.inv(b)) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def exp(self, a: int, e: int) -> int:
        if e < 0:
            return pow(self.inv(a), -e, self.p)
        return pow(a, e, self.p)

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError("inverse of zero in prime field")
        return pow(a, self.p - 2, self.p)

    def batch_inv(self, values: Sequence[int]) -> List[int]:
        """Montgomery's trick: n inverses for ONE exponentiation and 3(n-1)
        multiplications.  The verifier's hot path — per-query Z(x) and FRI
        quartic denominators batch through here (a Fermat inversion of the
        128-bit modulus costs ~30 us; a multiplication ~0.1 us)."""
        n = len(values)
        if n == 0:
            return []
        prefix = [0] * n               # prefix[i] = prod(values[:i])
        acc = 1
        for i, v in enumerate(values):
            v %= self.p
            if v == 0:
                raise ZeroDivisionError("inverse of zero in prime field")
            prefix[i] = acc
            acc = acc * v % self.p
        inv_acc = pow(acc, self.p - 2, self.p)
        out = [0] * n
        for i in range(n - 1, -1, -1):
            out[i] = prefix[i] * inv_acc % self.p
            inv_acc = inv_acc * values[i] % self.p
        return out

    # ----- roots of unity ---------------------------------------------------
    @property
    def two_adicity(self) -> int:
        n = self.p - 1
        k = 0
        while n % 2 == 0:
            n //= 2
            k += 1
        return k

    @lru_cache(maxsize=None)
    def two_adic_generator(self) -> int:
        """Deterministic generator of the maximal 2-power subgroup: the first
        g = 2, 3, ... whose image h = g^((p-1)/2^s) has exact order 2^s."""
        p = self.p
        s = self.two_adicity
        q = (p - 1) >> s
        g = 2
        while True:
            h = pow(g, q, p)
            if s == 0:
                return 1
            if pow(h, 1 << (s - 1), p) == p - 1:
                return h
            g += 1

    def get_root_of_unity(self, n: int) -> int:
        """Primitive n-th root of unity (n must be a power of 2 dividing p-1)."""
        if n & (n - 1):
            raise ValueError(f"domain size {n} is not a power of 2")
        if n.bit_length() - 1 > self.two_adicity:
            raise ValueError(f"field has no root of unity of order {n}")
        return pow(self.two_adic_generator(), 1 << (self.two_adicity - (n.bit_length() - 1)), self.p)

    def get_power_series(self, seed: int, length: int) -> List[int]:
        out = [1] * length
        acc = 1
        for i in range(1, length):
            acc = (acc * seed) % self.p
            out[i] = acc
        return out

    # ----- polynomial ops (coefficient form, lowest degree first) -----------
    def mul_polys(self, a: Sequence[int], b: Sequence[int]) -> List[int]:
        out = [0] * (len(a) + len(b) - 1)
        for i, ai in enumerate(a):
            if ai == 0:
                continue
            for j, bj in enumerate(b):
                out[i + j] = (out[i + j] + ai * bj) % self.p
        return out

    def eval_poly_at(self, poly: Sequence[int], x: int) -> int:
        acc = 0
        for c in reversed(poly):
            acc = (acc * x + c) % self.p
        return acc

    def interpolate(self, xs: Sequence[int], ys: Sequence[int]) -> List[int]:
        """Lagrange interpolation through arbitrary points -> coefficients.

        Used for boundary-constraint interpolants and FRI remainder checks.
        """
        n = len(xs)
        assert n == len(ys)
        # root poly prod (x - x_i)
        root = [1]
        for x in xs:
            root = self.mul_polys(root, [(-x) % self.p, 1])
        nums = [_div_linear(root, xs[i], self.p) for i in range(n)]
        inv_ds = self.batch_inv(
            [self.eval_poly_at(nums[i], xs[i]) for i in range(n)])
        out = [0] * n
        for i in range(n):
            c = (ys[i] * inv_ds[i]) % self.p
            num = nums[i]
            for j in range(n):
                out[j] = (out[j] + num[j] * c) % self.p
        return out

    def interpolate_roots(self, ys: Sequence[int]) -> List[int]:
        """Inverse NTT over the natural domain of size len(ys) (powers of the
        canonical root of unity).  Small host-side version: the verifier's
        cyclic and public-input static registers."""
        n = len(ys)
        w_inv = self.inv(self.get_root_of_unity(n))
        coeffs = _ntt_host(list(ys), w_inv, self.p)
        n_inv = self.inv(n)
        return [(c * n_inv) % self.p for c in coeffs]

    # ----- PRNG -------------------------------------------------------------
    def prng(self, seed: bytes, count: int = None):
        """sha256-counter PRNG producing field elements.

        The scheme, fixed for this framework (the JAX package's):

            state = sha256(seed)
            v_i   = int_be(sha256(state || u64_be(i))) mod p

        `prng(seed)` with no count returns v_0 as a scalar.
        """
        state = hashlib.sha256(seed).digest()
        single = count is None
        n = 1 if single else count
        out = []
        for i in range(n):
            h = hashlib.sha256(state + i.to_bytes(8, "big")).digest()
            out.append(int.from_bytes(h, "big") % self.p)
        return out[0] if single else out


def _div_linear(poly: Sequence[int], root: int, p: int) -> List[int]:
    """Divide poly by (x - root) exactly (synthetic division)."""
    n = len(poly)
    out = [0] * (n - 1)
    carry = 0
    for i in reversed(range(1, n)):
        carry = (poly[i] + carry * root) % p
        out[i - 1] = carry
    return out


def _ntt_host(values: List[int], w: int, p: int) -> List[int]:
    """Simple recursive NTT for host-side (small) transforms."""
    n = len(values)
    if n == 1:
        return values
    even = _ntt_host(values[0::2], (w * w) % p, p)
    odd = _ntt_host(values[1::2], (w * w) % p, p)
    out = [0] * n
    wk = 1
    for k in range(n // 2):
        t = (wk * odd[k]) % p
        out[k] = (even[k] + t) % p
        out[k + n // 2] = (even[k] - t) % p
        wk = (wk * w) % p
    return out
