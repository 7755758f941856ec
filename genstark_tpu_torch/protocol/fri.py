"""Fold-by-4 FRI: the prover's device fold and host checks.

Counterpart of ``genstark_tpu/protocol/fri.py``: `fold_traced` (:326-378)
on torch, `get_augmented_positions` (:50) and the remainder degree check of
`LowDegreeProver.verify_remainder` (:275).  The proof dataclasses are in
protocol/proof.py.

The fold needs no quartic interpolation: for a row with xs = {x, qx, -x,
-qx} (q a primitive 4th root of unity) the Lagrange evaluation at specialX
s is

    P(s) = inv4 * invx^3 * [ (s^2+x^2) (y0 (s+x) - y2 (s-x))
                           + invq (s^2-x^2) (y1 (s+qx) - y3 (s-qx)) ]
"""

from __future__ import annotations

from typing import List

import torch

MAX_REMAINDER_LENGTH = 256


class StarkError(Exception):
    pass


def get_augmented_positions(positions: List[int], column_length: int) -> List[int]:
    """FRI-local augmentation: pos mod rowLength, insertion-ordered dedup."""
    row_length = column_length // 4
    out = dict()
    for p in positions:
        out[p % row_length] = True
    return list(out.keys())


def fold(dev, field, root_of_unity: int, domain_size: int, depth: int,
         values: torch.Tensor, c_s: torch.Tensor, c_s2: torch.Tensor,
         xtabs) -> torch.Tensor:
    """Quartic fold at `depth`: values [L, N] -> [L, N/4] with
    N = domain_size / 4^depth.  c_s / c_s2: specialX and specialX^2 as
    [L, 1] Montgomery; xtabs: (x_tab, ix_tab) [L, N/4] tables of
    (w^(4^depth))^i and their inverses.  Representation-preserving: every
    value multiply carries a Montgomery coefficient."""
    f = field.host
    M = (domain_size // 4 ** depth) // 4
    x, ix = xtabs
    q = f.exp(root_of_unity, domain_size // 4)       # primitive 4th root
    inv4 = f.inv(4)
    c_q = dev.const(q, shape=(1,))
    c4 = dev.const(inv4, shape=(1,))
    c4q = dev.const(f.mul(inv4, f.inv(q)), shape=(1,))

    y = values.reshape(dev.L, 4, M)
    y0, y1, y2, y3 = y[:, 0], y[:, 1], y[:, 2], y[:, 3]
    x2 = dev.mont_mul(x, x)
    qx = dev.mont_mul(c_q, x)
    s_plus_x = dev._add(c_s, x)
    s_minus_x = dev._sub(c_s, x)
    t02 = dev.mont_mul(dev._add(c_s2, x2),
                       dev._sub(dev.mont_mul(y0, s_plus_x),
                                dev.mont_mul(y2, s_minus_x)))
    t13 = dev.mont_mul(dev._sub(c_s2, x2),
                       dev._sub(dev.mont_mul(y3, dev._sub(c_s, qx)),
                                dev.mont_mul(y1, dev._add(c_s, qx))))
    ix3 = dev.mont_mul(dev.mont_mul(ix, ix), ix)
    acc = dev._add(dev.mont_mul(t02, c4), dev.mont_mul(t13, c4q))
    return dev.mont_mul(acc, ix3)


def verify_remainder(field, extension_factor: int, remainder: List[int],
                     max_degree_plus1: int, root_of_unity: int) -> None:
    """Exclude extension-factor multiples, interpolate maxDegreePlus1 of
    the rest, check every other point (raises StarkError)."""
    f = field.host
    ext = extension_factor
    positions = [i for i in range(len(remainder)) if not ext or i % ext]
    if max_degree_plus1 > len(positions):
        raise StarkError("Remainder degree is greater than number of remainder values")
    domain = f.get_power_series(root_of_unity, len(remainder))
    xs = [domain[positions[i]] for i in range(max_degree_plus1)]
    ys = [remainder[positions[i]] for i in range(max_degree_plus1)]
    poly = f.interpolate(xs, ys)
    for i in range(max_degree_plus1, len(positions)):
        p = positions[i]
        if f.eval_poly_at(poly, domain[p]) != remainder[p]:
            raise StarkError(
                f"Remainder is not a valid degree {max_degree_plus1 - 1} polynomial")
