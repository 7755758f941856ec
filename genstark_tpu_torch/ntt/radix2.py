"""Radix-2 NTT for the fields the digit DFT does not take (P64, P224, P256):
kernel 8 of the port and its plain version.

Counterpart of the JAX package's non-MXU transform: `ntt_core_table`
(`genstark_tpu/ntt/__init__.py:493`), its local four-step split
`_four_step_core` (:445) and the multi-stage butterfly kernel
`pallas_kernels.multistage` (:286).

A local transform (at most LOCAL_MAX points) is one `butterfly` call: bit
reversal on the way in, every radix-2 DIT stage, natural order out.  A
larger n = n1 * n2 runs as a four-step (Bailey) split with natural order in
and out: n1-point transforms down the columns of A[i1, i2] (i = i1*n2 + i2),
one elementwise multiply by the panel w^(k1*i2), n2-point transforms along
the rows, the result written as X[k1 + n1*k2].  The plan's scale (n^-1 for
the inverse, R^-1 for the standard-form LDE) is folded into that panel, or,
for a transform of one local size, applied by one multiply by a constant.
Both multiplies are the field's public `mont_mul` (kernel 5 on the card).

LOCAL_MAX is the port's own threshold: kernel 8 keeps a whole local
transform of L x n int32 limbs in one block's shared memory, and 2048
points at L = 16 are 128 KB of the 227 KB a block may have
(kernels.butterfly_max_n).  The four-step split then covers n up to 2^22;
larger transforms wait for split mode.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..field.limbs import ints_to_limbs, power_series_mont_np

LOCAL_MAX = 2048


def _panel_np(params, root: int, n1: int, n2: int, scale: int) -> np.ndarray:
    """[L, n1*n2] Montgomery panel, entry k1*n2 + i2 = scale * root^(k1*i2)."""
    p = params.modulus
    vals = []
    step = 1
    for _ in range(n1):                       # row k1: powers of root^k1
        cur = scale * params.R_mod % p
        for _ in range(n2):
            vals.append(cur)
            cur = cur * step % p
        step = step * root % p
    return ints_to_limbs(vals, params.L)


class Radix2Plan:
    """Device tables for one (field, n, root, scale): the local roots'
    half-tables ([L, m/2], Montgomery powers of the m-th root), and either
    the four-step panel (scale folded in) or the scale as a constant."""

    def __init__(self, field, dev, n: int, root: int, scale: int = 1):
        if n < 2 or n & (n - 1):
            raise ValueError(f"transform size {n} is not a power of two >= 2")
        params = field.params
        p = field.modulus
        root %= p
        scale %= p
        half = lambda w, m: dev.from_numpy(power_series_mont_np(params, w, m // 2))
        self.n = n
        self.panel = self.scale = None
        if n <= LOCAL_MAX:
            self.split = None
            self.tables = (half(root, n),)
            if scale != 1:
                self.scale = dev.const(scale, shape=(1,))
        else:
            n1 = 1 << ((n.bit_length() - 1) // 2)
            n2 = n // n1
            if n2 > LOCAL_MAX:
                raise NotImplementedError(
                    f"a {n}-point radix-2 transform needs split mode (local size "
                    f"{n2} > {LOCAL_MAX}), which is not ported yet")
            self.split = (n1, n2)
            self.tables = (half(pow(root, n2, p), n1), half(pow(root, n1, p), n2))
            self.panel = dev.from_numpy(_panel_np(params, root, n1, n2, scale))


# ------------------------------------------------------------ plain version
def _bitrev(n: int, device) -> torch.Tensor:
    bits = n.bit_length() - 1
    idx = torch.arange(n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def butterfly_ref(dev, x: torch.Tensor, table: torch.Tensor,
                  out: torch.Tensor = None) -> torch.Tensor:
    """Plain kernel 8: x [B, G, L, n] (any strides) -> the n-point
    transform of each of the B*G rows over the root whose half-table is
    `table` [L, n/2], into `out` [B, G, L, n] or a new contiguous tensor.
    The JAX package's jnp stage loop on bit-reversed input, with the plain
    field's ops (`*_ref`), so on the card it launches no kernel of the
    port."""
    B, G, L, n = x.shape
    T = B * G
    y = x.permute(2, 0, 1, 3).reshape(L, T, n)[:, :, _bitrev(n, x.device)]
    half = n // 2
    m = 1
    while m < n:
        tw = table.reshape(L, m, half // m)[:, :, 0]            # w_(2m)^r, [L, m]
        yv = y.reshape(L, T, n // (2 * m), 2, m)
        lo, hi = yv[:, :, :, 0, :], yv[:, :, :, 1, :]
        t = dev.mont_mul_ref(hi, tw[:, None, None, :])
        y = torch.stack([dev.add_ref(lo, t), dev.sub_ref(lo, t)], dim=3).reshape(L, T, n)
        m *= 2
    res = y.reshape(L, B, G, n).permute(1, 2, 0, 3)
    if out is None:
        return res.contiguous()
    out.copy_(res)
    return out


# ------------------------------------------------------------ the wrapper
def butterfly(dev, x: torch.Tensor, table: torch.Tensor,
              out: torch.Tensor = None) -> torch.Tensor:
    """Local transforms (contract of butterfly_ref).  CPU tensors run the
    plain version; CUDA tensors launch kernel 8 or raise."""
    if x.device.type == "cpu":
        return butterfly_ref(dev, x, table, out)
    return kernels.butterfly(dev, x, table, out)


def _run(dev, a: torch.Tensor, plan: Radix2Plan, bfly, mul) -> torch.Tensor:
    n = plan.n
    L = a.shape[-2]
    batch_shape = tuple(a.shape[:-2])
    x = a.reshape((-1, L, n))
    B = x.shape[0]
    if plan.split is None:
        y = bfly(dev, x[:, None], plan.tables[0])[:, 0]         # [B, L, n]
        if plan.scale is not None:
            y = mul(y.transpose(0, 1), plan.scale).transpose(0, 1)
        return y.reshape(batch_shape + (L, n))
    n1, n2 = plan.split
    # pass 1: n1-point transforms over i1 (one per b, i2), written [L, B, k1, i2]
    y = torch.empty((L, B, n1, n2), dtype=torch.int32, device=x.device)
    bfly(dev, x.reshape(B, L, n1, n2).permute(0, 3, 1, 2), plan.tables[0],
         out=y.permute(1, 3, 0, 2))
    # the twiddle w^(k1*i2), with the plan's scale folded in
    z = mul(y.reshape(L, B, n), plan.panel[:, None, :])          # [L, B, n]
    # pass 2: n2-point transforms over i2 (one per b, k1), written X[k1 + n1*k2]
    out = torch.empty((B, L, n2, n1), dtype=torch.int32, device=x.device)
    bfly(dev, z.reshape(L, B, n1, n2).permute(1, 2, 0, 3), plan.tables[1],
         out=out.permute(0, 3, 1, 2))
    return out.reshape(batch_shape + (L, n))


def transform(dev, a: torch.Tensor, plan: Radix2Plan) -> torch.Tensor:
    """a [..., L, n] -> [..., L, n]: the plan's scale times the transform,
    natural order in and out.  CPU tensors run the plain versions; CUDA
    tensors launch kernels 8 and 5."""
    return _run(dev, a, plan, butterfly, dev.mont_mul)


def transform_ref(dev, a: torch.Tensor, plan: Radix2Plan) -> torch.Tensor:
    """The same transform from plain versions only, on any device."""
    return _run(dev, a, plan, butterfly_ref, dev.mont_mul_ref)
