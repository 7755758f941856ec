"""Inputs that hold a field kernel to its plain version where its word
chains are most likely to break: the values at which the last carry or
borrow of a chain decides (`edge_values`), planted where a kernel's first
butterflies add and subtract them as a pair (`edge_input`).

Numpy and Python integers only.  `chip_smoke.py` and the card tests
(`tests/test_torch_cuda.py`) build their kernel inputs with it.
"""

from __future__ import annotations

from .field.limbs import ints_to_limbs


def edge_values(field) -> list:
    """0, 1, 2, p - 1, p - 2, R mod p (the Montgomery one) and p >> 1: the
    values where the last carry or borrow of a word chain decides."""
    p = field.modulus
    return [0, 1, 2, p - 1, p - 2, field.params.R_mod % p, p >> 1]


def edge_pairs(field):
    """(xs, ys): every ordered pair of edge_values, as two lists."""
    vals = edge_values(field)
    return [x for x in vals for _ in vals], [y for _ in vals for y in vals]


def plant(field, limbs, values, at: int):
    """numpy limbs [L, n] with `values` written at columns at, at + 1, ...
    (as many as fit before n)."""
    values = values[:limbs.shape[1] - at]
    limbs[:, at:at + len(values)] = ints_to_limbs(values, field.params.L)
    return limbs


def edge_input(field, limbs, halves=None, shift: int = 0, root=None):
    """numpy canonical limbs [L, n] with ordered pairs (x, y) of edge_values
    planted where a first butterfly adds and subtracts them: the xs at
    columns 0, 1, ... and their partners at h, h + 1, ... for each h of
    `halves` (default n/2), as many pairs as fit below the least h, from
    pair `shift` on.

    Without `root`, h is half a local transform's size on kernel 8's natural
    entry: the input is bit-reversed as it loads, so the first stage pairs
    j with j + h against the twiddle 1, and the partner is y.  With `root`
    (the n-th root whose powers, in Montgomery form, are the stage table), h
    is a stage pass's lowest half-size m (kernels 7/9): butterfly j
    multiplies its hi by w_j = root^(j n / 2m), so y w_j^-1 is planted
    there and lo +- w_j hi add and subtract the pair itself."""
    n = limbs.shape[1]
    halves = (n // 2,) if halves is None else tuple(halves)
    xs, ys = edge_pairs(field)
    count = min(len(xs), min(halves))
    xs, ys = (xs[shift:] + xs[:shift])[:count], (ys[shift:] + ys[:shift])[:count]
    plant(field, limbs, xs, 0)
    p = field.modulus
    for h in halves:
        part = ys if root is None else [
            y * pow(root, n - j * n // (2 * h), p) % p for j, y in enumerate(ys)]
        plant(field, limbs, part, h)
    return limbs
