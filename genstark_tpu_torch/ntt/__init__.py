"""NTT / iNTT: chained digit-matmul DFT levels (every solinas field whose
spec counts the field's limbs: p32, 2^64 - 2^32 + 1, p128, p224, p256, and
the solinas moduli of 89-96, 153-160 and 185-192 bits) or the radix-2 path
(P64, the demo field 96769 and any other modulus).

`make_plan` picks the route per field by the JAX package's rule,
`mxu_applicable` (genstark_tpu/ntt/__init__.py:248): the digit DFT for every
modulus `dft.solinas_spec` takes with the field's own limb count
(`digit_dft_field`; kernel 1 is built for every L up to 16), the radix-2
plan of ``ntt/radix2.py`` (kernel 8, the four-step split, the stage passes)
for the others.  The JAX rule's size floor
(`_mxu_min_n`, 2^13) and its level cost model are tuned to the TPU's
measured rates (`_MXU_RATE`), which the port leaves out: the digit route
runs at every size.  `transform` runs either plan.  The
layer-level API of the JAX package, `ntt`, `intt` and `low_degree_extend`
(genstark_tpu/ntt/__init__.py:583-607), runs `transform` on canonical plans
kept by the values' DeviceField (one per modulus and device), per size and
direction.

The digit route is the counterpart of the multi-level transform in
``genstark_tpu/ntt/__init__.py`` (`mxu_table_specs` :255, `MxuPlan` :291,
`mxu_transform_core` :353): every transform over a solinas field runs
through the DFT level of ``ntt/dft.py`` at every size.

An n-point transform is split into q levels of size m_1 * ... * m_q = n
(Bailey / 4-step generalized).  Natural order in and out.  Level 1's digit
matrix carries a uniform `scale`, which folds the iNTT's n^-1 or the LDE's
R^-1 into the transform for free; level l's twiddle w_l^(k * (col % rest))
is fused into that level's epilogue, and every level but the last emits
int8 digit planes that the next level consumes directly.

The port's own level split: levels of at most 2^6 points (one level for
n < 128), split near-equally.  The DFT kernel runs the digit products on
the int8 tensor cores in slices of 64 of j, so one slice holds a whole
level.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..field.device import DeviceField
from . import dft, radix2
from .radix2 import Radix2Plan

MAX_LEVEL_BITS = 6


@lru_cache(maxsize=None)
def dft_levels(n: int):
    """Level sizes for an n-point transform (n a power of two)."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"transform size {n} is not a power of two >= 2")
    bits = n.bit_length() - 1
    q = max(1, -(-bits // MAX_LEVEL_BITS))
    base, extra = divmod(bits, q)
    return tuple(1 << (base + (1 if i < extra else 0)) for i in range(q))


def _twiddle_split(rest: int) -> int:
    """Inner size s of the factored twiddle for `rest` columns, or 0 for a
    direct [L, m, rest] panel (rest up to 2^MAX_LEVEL_BITS)."""
    if rest <= (1 << MAX_LEVEL_BITS):
        return 0
    b = rest.bit_length() - 1
    return 1 << (-(-b // 2))


def table_specs(field, n: int, root: int, scale: int = 1):
    """Host-side table recipe for one transform: (digit-matrix roots per
    level, twiddle spec per level).  A twiddle spec is None (rest == 1),
    ("d", w_l, rest) for a direct panel, or ("f", A_seed, rest//s, B_seed, s)
    for the factored pair A[k, h] = w_l^(k*h*s), B[k, t] = w_l^(k*t)."""
    levels = dft_levels(n)
    p = field.modulus
    root %= p
    w8_roots, tws = [], []
    n_l = n
    for m in levels:
        rest = n_l // m
        w_l = pow(root, n // n_l, p)        # canonical n_l-root wrt `root`
        w8_roots.append(pow(w_l, rest, p))  # canonical m-root
        if rest == 1:
            tws.append(None)
        else:
            s = _twiddle_split(rest)
            tws.append(("d", w_l, rest) if s == 0 else
                       ("f", pow(w_l, s, p), rest // s, w_l, s))
        n_l = rest
    return w8_roots, tws


def digit_dft_field(field) -> bool:
    """True for the fields the digit DFT takes: `dft.solinas_spec` accepts
    the modulus, counts the field's own limbs (its L equals
    `field.params.L`), and kernel 1 is built for that limb count (p32,
    2^64 - 2^32 + 1, p128, p224, p256, and the solinas moduli of 89-96,
    153-160 and 185-192 bits).

    The spec counts limbs from the modulus's bytes, the field from its
    32-bit words, so the two differ when the byte count is 2 mod 4 (9-16,
    41-48, 73-80, 105-112, 137-144, 169-176, 201-208 and 233-240 bits):
    the spec's digit planes would then miss the field's top limb.  Those
    moduli take the radix-2 route, which computes the same transform."""
    spec = dft.solinas_spec(field.modulus)
    return (spec is not None and spec[0] == field.params.L
            and field.params.L in kernels.DFT_LS)


class DftPlan:
    """Device tables for one (field, n, root, scale): per-level W digit
    planes (int8; level 1 carries the scale) and twiddle tables (int32
    Montgomery), all on the DeviceField's device."""

    def __init__(self, field, dev: DeviceField, n: int, root: int, scale: int = 1):
        if not digit_dft_field(field):
            raise NotImplementedError(
                "the digit DFT takes the solinas fields only (see "
                "digit_dft_field); make_plan gives the radix-2 plan for the others")
        self.n = n
        self.levels = dft_levels(n)
        w8_roots, tws = table_specs(field, n, root, scale)
        params = field.params
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev.device)
        self.w8s = [to_dev(dft.w_digits(field, m, r, scale if lvl == 0 else 1))
                    for lvl, (m, r) in enumerate(zip(self.levels, w8_roots))]
        self.tws = []
        for m, spec in zip(self.levels, tws):
            if spec is None:
                self.tws.append(None)
            elif spec[0] == "d":
                _, w_l, rest = spec
                self.tws.append({"p": dev.from_numpy(
                    dft._direct_panel_np(params, w_l, m, rest))})
            else:
                _, a_seed, ca, b_seed, sb = spec
                # A stored [h, L, m] (the JAX kernel's layout)
                self.tws.append({
                    "a": dev.from_numpy(np.transpose(
                        dft._panel_grid_np(params, a_seed, m, ca), (2, 0, 1))),
                    "b": dev.from_numpy(dft._panel_grid_np(params, b_seed, m, sb))})


def make_plan(field, dev: DeviceField, n: int, root: int, scale: int = 1):
    """The transform plan for one (field, n, root, scale): a DftPlan for
    every solinas field (`digit_dft_field`), a Radix2Plan for any other."""
    if digit_dft_field(field):
        return DftPlan(field, dev, n, root, scale)
    return Radix2Plan(field, dev, n, root, scale)


def _plan(field, dev: DeviceField, n: int, inverse: bool):
    """The canonical n-point plan of `field` on dev's device, forward or
    inverse (n^-1 folded), made once and kept by the DeviceField (one per
    modulus and device): a repeated call builds and uploads no table."""
    plan = dev.plans.get((n, inverse))
    if plan is None:
        f = field.host
        root = f.get_root_of_unity(n)
        if inverse:
            plan = make_plan(field, dev, n, f.inv(root), f.inv(n % field.modulus))
        else:
            plan = make_plan(field, dev, n, root)
        dev.plans[(n, inverse)] = plan
    return plan


def _canonical(field, values: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
    if values.shape[-1] != n:
        raise ValueError(f"values hold {values.shape[-1]} points, not {n}")
    if n == 1:
        return values.clone()
    dev = field.device_field(values.device)
    return transform(dev, values, _plan(field, dev, n, inverse))


def ntt(field, values: torch.Tensor, n: int = None) -> torch.Tensor:
    """Forward NTT (the JAX `ntt.ntt`, genstark_tpu/ntt/__init__.py:583):
    evaluations of the polynomial with coefficients `values` [..., L, n]
    (Montgomery int32 limbs, on any device) at the powers of the canonical
    n-th root of unity.  The digit route (kernel 1) for the solinas fields,
    the radix-2 route (kernels 8, 7/9, 5) for every other field."""
    return _canonical(field, values, n or values.shape[-1], False)


def intt(field, values: torch.Tensor) -> torch.Tensor:
    """Inverse NTT (`ntt.intt`, :590): interpolation over the canonical
    domain, scaled by n^-1 (folded into the plan)."""
    return _canonical(field, values, values.shape[-1], True)


def low_degree_extend(field, coeffs: torch.Tensor, target_n: int) -> torch.Tensor:
    """Evaluations of the polynomials coeffs [..., L, n] over the canonical
    domain of size target_n >= n (`ntt.low_degree_extend`, :597)."""
    src_n = coeffs.shape[-1]
    if target_n < src_n:
        raise ValueError("target domain smaller than coefficient count")
    if target_n > src_n:
        coeffs = torch.nn.functional.pad(coeffs, (0, target_n - src_n))
    return ntt(field, coeffs, target_n)


def transform(dev: DeviceField, a: torch.Tensor, plan) -> torch.Tensor:
    """a [..., L, n] -> [..., L, n], natural order in and out, equal to the
    radix-2 transform times the plan's folded scale."""
    if isinstance(plan, Radix2Plan):
        return radix2.transform(dev, a, plan)
    return _digit_transform(dev, a, plan)


def _digit_transform(dev: DeviceField, a: torch.Tensor, plan: DftPlan) -> torch.Tensor:
    """Multi-level NTT through the DFT levels of a DftPlan."""
    n = plan.n
    levels = plan.levels
    q = len(levels)
    L = a.shape[-2]
    batch_shape = tuple(a.shape[:-2])
    x = a.reshape((-1, L, n))
    Bc = x.shape[0]
    cur = x.permute(1, 0, 2)                           # [L, Bc, n]
    pre, rest = Bc, n
    for lvl, m in enumerate(levels):
        rest //= m
        # level 0 reads the limbs (the kernel encodes their digits as it
        # loads them), later levels the previous level's digit planes; both
        # as the strided view [planes, pre, m, rest], with no copy
        curv = cur.reshape(cur.shape[0], pre, m, rest)
        out_dig = lvl < q - 1
        o = dft.run_dft_level(dev, plan.w8s[lvl], curv, m, rest,
                              plan.tws[lvl] if rest > 1 else None, out_digits=out_dig)
        cur = o.reshape(o.shape[0], m * pre, rest)     # pre' = (k_lvl, pre)
        pre *= m
    # cur: [L, k_q, ..., k_1, Bc] -> [Bc, L, (k_q, ..., k_1)]
    cur = cur.reshape((L,) + tuple(reversed(levels)) + (Bc,))
    perm = (q + 1, 0) + tuple(range(1, q + 1))
    out = cur.permute(perm).reshape(Bc, L, n)
    return out.reshape(batch_shape + (L, n))
