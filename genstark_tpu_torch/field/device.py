"""Device-side prime-field arithmetic over torch tensors of 16-bit limbs.

Counterpart of ``genstark_tpu/field/device.py`` (the surface the prover's
main path uses).  Layout: an array of N elements is ``int32[L, N]`` — limbs
along the leading axis, each limb a value below 2^16, exactly the bits of
the JAX package's ``uint32[L, N]``.  The plain versions widen to int64
inside, so no intermediate can wrap (torch has no uint32 add, shift or
compare on the CPU); the kernels read the int32 limbs as uint32.  Values on the device are kept in Montgomery form (x*R mod p with
R = 2^(16 L)) unless a caller documents standard form.

Two layers, as in the JAX package (`DeviceField` over `field/pallas_ops.py`):

- the plain versions `mont_mul_ref`, `add_ref`, `sub_ref` and
  `outer_table_ref`: plain torch on whatever device their inputs lie.  They
  are the arithmetic of kernels 5 (`field_ew`) and 6 (`outer_table`), and the
  plain versions that other kernels' plain versions are built from;
- the public ops `mont_mul`, `_add`, `_sub` and `outer_table` (and every op
  derived from them, among them the JAX package's public names `add`,
  `sub`, `neg`, `mul`, `sqr`, `to_mont`, `from_mont`, `power_series` and
  `combine_many`): a CPU tensor runs the plain version; any other tensor
  launches kernel 5 or 6 (csrc/field_ops.cu) or raises.  The kernels take
  any L, any broadcast and any strides, so none of the JAX package's TPU
  dispatch rules (2^16-element minimum, 2048-lane tiles, L >= 8) applies.

The batched inverse `inv` (plain version `inv_ref`) is Montgomery's trick
over the products above, as in the JAX package; its one total is inverted
by `mont_inv` (kernel A, csrc/field_ops.cu: a binary GCD; plain version
`mont_pow_ref(a, p - 2)`, the JAX package's Fermat ladder), so an inverse
stays on the device.

`from_numpy` uploads from pinned memory, asynchronously (a pageable
host-to-device copy synchronizes the stream as a fetch does), and `const`
and `one` are memoized per DeviceField, keyed by (value, rank, form), so a
warm prove uploads no constant.  The schema's constants and the prover's
few scalars bound the cache.  Callers never write into a constant.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .. import kernels, tracing
from .limbs import LIMB_BITS, LIMB_MASK, MontParams, int_to_limbs, ints_to_limbs, limbs_to_ints

_I64 = torch.int64
_I32 = torch.int32


class DeviceField:
    """Vectorized Montgomery arithmetic for one prime modulus on one device."""

    def __init__(self, params: MontParams, *, device="cuda"):
        self.params = params
        self.L = params.L
        self.p = params.modulus
        self.n0p = params.n0p
        self.device = torch.device(device)
        self._p64 = tracing.upload(params.p_limbs.astype(np.int64), _I64, self.device)
        self._consts = {}
        self.plans = {}      # the public NTT's plans (ntt._plan), per (n, inverse)

    # ----- host <-> device conversion ---------------------------------------
    def from_numpy(self, arr: np.ndarray) -> torch.Tensor:
        """numpy u32 16-bit limbs (any shape) -> int32 tensor on the device,
        without a synchronization: on the card the limbs are written once
        into pinned host memory and copied on the current stream (the
        caching host allocator keeps the block until that copy is done)."""
        arr = np.ascontiguousarray(arr)
        if self.device.type == "cpu":
            return torch.from_numpy(arr.astype(np.int32))
        host = torch.empty(arr.shape, dtype=_I32, pin_memory=True)
        np.copyto(host.numpy(), arr, casting="unsafe")
        return host.to(self.device, non_blocking=True)

    def to_numpy(self, t: torch.Tensor) -> np.ndarray:
        """int32 limb tensor -> numpy u32 (the JAX package's layout)."""
        return tracing.fetch(t.detach()).numpy().astype(np.uint32)

    def from_ints(self, values: Sequence[int], to_mont: bool = True) -> torch.Tensor:
        arr = self.from_numpy(ints_to_limbs(values, self.L))
        return self._to_mont(arr) if to_mont else arr

    def to_ints(self, arr: torch.Tensor, from_mont: bool = True) -> List[int]:
        if from_mont:
            arr = self._from_mont(arr)
        return limbs_to_ints(self.to_numpy(arr).reshape(self.L, -1))

    def const(self, value: int, shape=(), to_mont: bool = True) -> torch.Tensor:
        """Broadcastable constant: [L] + [1]*len(shape), uploaded once per
        (value, rank, form) and shared: never written into."""
        key = (value % self.p, len(shape), to_mont)
        t = self._consts.get(key)
        if t is None:
            value = key[0] * self.params.R_mod % self.p if to_mont else key[0]
            t = self.from_numpy(int_to_limbs(value, self.L)).reshape(
                (self.L,) + (1,) * len(shape))
            self._consts[key] = t
        return t

    def one(self, shape=()) -> torch.Tensor:
        """Montgomery representation of 1, broadcastable over shape."""
        return self.const(1, shape)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros((self.L,) + tuple(shape), dtype=_I32, device=self.device)

    # ----- the public ops: plain version on the CPU, kernels elsewhere -----
    def mont_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a*b*R^-1 mod p over int32 [L, ...] broadcast-compatible operands."""
        if a.device.type == "cpu":
            return self.mont_mul_ref(a, b)
        return kernels.field_ew(self, "mul", a, b)

    def _add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.device.type == "cpu":
            return self.add_ref(a, b)
        return kernels.field_ew(self, "add", a, b)

    def _sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.device.type == "cpu":
            return self.sub_ref(a, b)
        return kernels.field_ew(self, "sub", a, b)

    def outer_table(self, outer: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
        """[L, nj] x [L, s] -> [L, nj*s], t[j*s + k] = outer[j]*inner[k]
        (factored power-table regeneration)."""
        if outer.device.type == "cpu":
            return self.outer_table_ref(outer, inner)
        return kernels.outer_table(self, outer, inner)

    # ----- plain versions of kernels 5 and 6 --------------------------------
    def outer_table_ref(self, outer: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
        full = self.mont_mul_ref(outer[:, :, None], inner[:, None, :])
        return full.reshape(self.L, outer.shape[1] * inner.shape[1])

    def _align(self, a: torch.Tensor, b: torch.Tensor):
        """Batch axes broadcast right-aligned AFTER the limb axis: a
        lower-rank operand gets singleton batch dims right after axis 0."""
        L = self.L
        if a.dim() < b.dim():
            a = a.reshape((L,) + (1,) * (b.dim() - a.dim()) + tuple(a.shape[1:]))
        elif b.dim() < a.dim():
            b = b.reshape((L,) + (1,) * (a.dim() - b.dim()) + tuple(b.shape[1:]))
        return a.to(_I64), b.to(_I64)

    def _plimbs(self, ndim: int) -> torch.Tensor:
        return self._p64.reshape((self.L,) + (1,) * ndim)

    def mont_mul_ref(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """SOS Montgomery multiplication: a*b*R^-1 mod p, canonical.

        a, b: int32/int64 [L, ...] broadcast-compatible, limbs < 2^16.  Same
        lazy-accumulator schedule as the JAX DeviceField.mont_mul: partial
        products split into lo/hi halves added into a [2L+1, ...]
        accumulator, carries resolved once per reduction step."""
        L = self.L
        a, b = self._align(a, b)
        shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
        acc = torch.zeros((2 * L + 1,) + tuple(shape), dtype=_I64, device=a.device)
        for i in range(L):
            prod = a[i][None] * b                          # [L, ...]
            acc[i:i + L] += prod & LIMB_MASK
            acc[i + 1:i + L + 1] += prod >> LIMB_BITS
        p = self._plimbs(len(shape))
        c = torch.zeros(shape, dtype=_I64, device=a.device)
        for i in range(L):
            x = acc[i] + c
            m = ((x & LIMB_MASK) * self.n0p) & LIMB_MASK
            mp = m[None] * p                               # [L, ...]
            c = (x + (mp[0] & LIMB_MASK)) >> LIMB_BITS
            if L > 1:
                acc[i + 1:i + L] += mp[1:] & LIMB_MASK
            acc[i + 1:i + L + 1] += mp >> LIMB_BITS
        t = []
        for k in range(L):
            s = acc[L + k] + c
            t.append(s & LIMB_MASK)
            c = s >> LIMB_BITS
        return self._cond_sub_p(t, c)

    def _cond_sub_p(self, limbs: List[torch.Tensor], carry: torch.Tensor) -> torch.Tensor:
        """Given value = carry*2^(16L) + limbs < 2p, subtract p if >= p."""
        diff = []
        borrow = torch.zeros_like(limbs[0])
        for j in range(self.L):
            s = limbs[j] - int(self.params.p_limbs[j]) - borrow
            diff.append(s & LIMB_MASK)
            borrow = (s < 0).to(_I64)
        take = (carry != 0) | (borrow == 0)
        return torch.where(take, torch.stack(diff), torch.stack(limbs)).to(_I32)

    def add_ref(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = self._align(a, b)
        s = a + b
        t = []
        c = torch.zeros_like(s[0])
        for j in range(self.L):
            v = s[j] + c
            t.append(v & LIMB_MASK)
            c = v >> LIMB_BITS
        return self._cond_sub_p(t, c)

    def sub_ref(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = self._align(a, b)
        d = a - b
        t = []
        borrow = torch.zeros_like(d[0])
        for j in range(self.L):
            v = d[j] - borrow
            t.append(v & LIMB_MASK)
            borrow = (v < 0).to(_I64)
        # if the difference went negative, add p back
        t2 = []
        c = torch.zeros_like(borrow)
        for j in range(self.L):
            v = t[j] + int(self.params.p_limbs[j]) + c
            t2.append(v & LIMB_MASK)
            c = v >> LIMB_BITS
        out = torch.where(borrow.bool(), torch.stack(t2), torch.stack(t))
        return out.to(_I32)

    def _neg(self, a: torch.Tensor) -> torch.Tensor:
        return self._sub(self.zeros(a.shape[1:]), a)

    def _sqr(self, a: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(a, a)

    def _to_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(a, self.const(self.params.R2_mod, a.shape[1:], to_mont=False))

    def _from_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(a, self.const(1, a.shape[1:], to_mont=False))

    # ----- the JAX DeviceField's public names (device.py:44-56) ----------------
    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._add(a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._sub(a, b)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self._neg(a)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(a, b)

    def sqr(self, a: torch.Tensor) -> torch.Tensor:
        return self._sqr(a)

    def to_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self._to_mont(a)

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self._from_mont(a)

    def power_series(self, seed: int, length: int) -> torch.Tensor:
        """[1, s, s^2, ..., s^(length-1)] in Montgomery form [L, length] by
        doubling (the JAX `_power_series`, device.py:359-372): one product
        a doubling, by the multiplier s^cur built on the host; the
        multipliers go up in one upload (`from_ints`)."""
        if length < 1:
            raise ValueError("power_series takes a length of at least 1")
        steps = []
        cur = 1
        while cur < length:
            steps.append(pow(seed, cur, self.p))
            cur *= 2
        out = self.one((1,))
        if steps:
            mults = self.from_ints(steps)
            for k in range(len(steps)):
                out = torch.cat([out, self.mont_mul(out, mults[:, k:k + 1])], dim=1)
        return out[:, :length]

    def combine_many(self, vectors, coeffs: Sequence[int]) -> torch.Tensor:
        """sum_k coeffs[k] * vectors[k] (the JAX `_combine_many`,
        device.py:386-398); vectors: list of [L, N] Montgomery (or a [K, L,
        N] tensor), coeffs: python ints, uploaded at once (`from_ints`, not
        the memoized `const`: transcript coefficients change every prove)."""
        return self.combine_many_mont(vectors, self.from_ints(coeffs))

    # ----- derived ops (through the public ops) ------------------------------
    def _exp_static(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e for a small python-int exponent (square-and-multiply)."""
        e %= (self.p - 1) if self.p > 2 else 1
        if e == 0:
            return self.one(a.shape[1:]).expand(a.shape).contiguous()
        if e >= (1 << 24):
            raise ValueError("exp_static is for small static exponents")
        result = None
        base = a
        while e:
            if e & 1:
                result = base if result is None else self.mont_mul(result, base)
            e >>= 1
            if e:
                base = self.mont_mul(base, base)
        return result

    # ----- powers and the batched inverse ---------------------------------
    def mont_inv(self, a: torch.Tensor) -> torch.Tensor:
        """a^-1 (0 for 0) for Montgomery-form [L, n].  A CPU tensor runs
        `mont_pow_ref(a, p - 2)`; any other launches kernel A (a binary GCD,
        four lanes an element) or raises."""
        if a.device.type == "cpu":
            return self.mont_pow_ref(a, self.p - 2)
        return kernels.mont_inv(self, a)

    def mont_pow_ref(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """Plain version of kernel A at e = p - 2: the JAX package's
        `_fermat_inv_single` ladder (genstark_tpu/field/device.py:329) for
        any exponent e >= 1: from the top bit down, square, and multiply by
        a where the bit is set, on `mont_mul_ref`."""
        if e < 1:
            raise ValueError("mont_pow_ref takes an exponent e >= 1")
        result = a
        for bit in bin(e)[3:]:
            result = self.mont_mul_ref(result, result)
            if bit == "1":
                result = self.mont_mul_ref(result, a)
        return result.to(_I32)

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Elementwise inverse of Montgomery-form [L, ...] with inv(0) = 0.
        A CPU tensor runs `inv_ref`; on the card every product is one
        kernel-5 launch (2 ceil(log2 N) + 2 of them) and the total's
        inverse one kernel-A launch: nothing leaves the device."""
        if a.device.type == "cpu":
            return self.inv_ref(a)
        return self._inv_with(self.mont_mul, self.mont_inv, a)

    def inv_ref(self, a: torch.Tensor) -> torch.Tensor:
        """Plain version of `inv`: the same steps on `mont_mul_ref` and
        `mont_pow_ref(., p - 2)`."""
        return self._inv_with(self.mont_mul_ref, lambda t: self.mont_pow_ref(t, self.p - 2), a)

    def _inv_with(self, mul, inverse, a: torch.Tensor) -> torch.Tensor:
        """The JAX package's `DeviceField.inv` (genstark_tpu/field/device.py
        :294-357) over the product `mul` and the single inverse `inverse`:
        zeros masked to one, inclusive prefix and suffix products by
        Hillis-Steele doubling, the total inverted on the device, each
        element's inverse as prod_{k<i} * prod_{k>i} * total^-1, zeros put
        back."""
        L = self.L
        flat = a.reshape(L, -1)
        n = flat.shape[1]
        if n == 0:
            return a.clone()
        one = self.one((1,))
        is_zero = (flat == 0).all(dim=0)
        safe = torch.where(is_zero[None], one, flat)
        prefix, suffix = safe, safe
        k = 1
        while k < n:
            ident = one.expand(L, k)
            prefix = mul(prefix, torch.cat([ident, prefix[:, :-k]], dim=1))
            suffix = mul(suffix, torch.cat([suffix[:, k:], ident], dim=1))
            k *= 2
        total_inv = inverse(prefix[:, -1:].contiguous())
        pre_excl = torch.cat([one, prefix[:, :-1]], dim=1)
        suf_excl = torch.cat([suffix[:, 1:], one], dim=1)
        out = mul(mul(pre_excl, suf_excl), total_inv)
        return torch.where(is_zero[None], torch.zeros_like(out), out).reshape(a.shape)

    def combine_many_mont(self, vectors, coeffs_mont: torch.Tensor) -> torch.Tensor:
        """sum_k coeffs_mont[:, k] * vectors[k]; vectors: list of [L, N],
        coeffs_mont: [L, K] device coefficients."""
        acc = None
        for k in range(len(vectors)):
            term = self.mont_mul(vectors[k], coeffs_mont[:, k:k + 1])
            acc = term if acc is None else self._add(acc, term)
        return acc
