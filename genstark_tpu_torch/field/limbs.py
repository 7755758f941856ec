"""Limb representation and Montgomery parameters for prime fields.

Counterpart of ``genstark_tpu/field/limbs.py`` (a copy: the port cannot
import the JAX package).  Host arrays are numpy ``uint32[L, N]`` of 16-bit
limbs, little-endian limb order, limbs along the LEADING axis — the layout
the JAX package uses at its boundary.  On the device the same limbs are held
as ``torch.int32`` (a value below 2^16 has the same bits either way).

The wire format for field elements (proof serialization) is little-endian
bytes of ``element_size = ceil(bits/32)*4`` bytes.
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def element_size_for(modulus: int) -> int:
    """Bytes per serialized element: u32-limb count times 4 (reference layout)."""
    n_u32 = max(1, (modulus.bit_length() + 31) // 32)
    return n_u32 * 4


def limb_count_for(modulus: int) -> int:
    """Number of 16-bit limbs (element_size / 2)."""
    return element_size_for(modulus) // 2


def int_to_limbs(value: int, L: int) -> np.ndarray:
    """Python int -> np.uint32[L] of 16-bit limbs, little-endian."""
    out = np.empty(L, dtype=np.uint32)
    for i in range(L):
        out[i] = value & LIMB_MASK
        value >>= LIMB_BITS
    return out


def ints_to_limbs(values, L: int) -> np.ndarray:
    """Iterable of ints -> np.uint32[L, N] (values must be in [0, 2^(16L)))."""
    values = list(values)
    nbytes = 2 * L
    raw = b"".join(v.to_bytes(nbytes, "little") for v in values)
    return np.frombuffer(raw, dtype="<u2").reshape(len(values), L).T.astype(np.uint32)


def power_series_mont_np(params: "MontParams", seed: int, length: int) -> np.ndarray:
    """[1, s, s^2, ...] in Montgomery form as np.uint32[L, length], computed
    with host big-int arithmetic (one multiply per element — much cheaper
    than a compiled log-doubling chain, and keeps large power tables OUT of
    compiled programs where they would be baked in as multi-MB literals)."""
    p = params.modulus
    step = seed % p
    vals = []
    v = params.R_mod                       # Montgomery form of 1
    for _ in range(length):
        vals.append(v)
        v = v * step % p
    return ints_to_limbs(vals, params.L)


def limbs_to_ints(limbs: np.ndarray) -> list:
    """np.uint32[L, N] -> list of python ints."""
    L, n = limbs.shape
    vals = [0] * n
    for i in reversed(range(L)):
        row = limbs[i]
        for j in range(n):
            vals[j] = (vals[j] << LIMB_BITS) | int(row[j])
    return vals


class MontParams:
    """Montgomery-domain constants for a prime modulus with L 16-bit limbs."""

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.element_size = element_size_for(modulus)
        self.L = limb_count_for(modulus)
        self.R = 1 << (LIMB_BITS * self.L)
        assert self.R > modulus, "modulus does not fit in limb budget"
        assert modulus % 2 == 1, "Montgomery arithmetic requires an odd modulus"
        self.R_mod = self.R % modulus
        self.R2_mod = (self.R * self.R) % modulus
        # n0' = -p^{-1} mod 2^16
        p_inv = pow(modulus, -1, 1 << LIMB_BITS)
        self.n0p = (-p_inv) % (1 << LIMB_BITS)
        self.p_limbs = int_to_limbs(modulus, self.L)
        self.r2_limbs = int_to_limbs(self.R2_mod, self.L)
