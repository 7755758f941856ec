"""Radix-2 NTT for the fields the digit DFT does not take (P64, P224, P256):
kernels 7, 8 and 9 of the port and their plain versions.

Counterpart of the JAX package's non-MXU transform: `ntt_core_table`
(`genstark_tpu/ntt/__init__.py:493`), its local four-step split
`_four_step_core` (:445) with the size rule `_four_step_local` (:422), the
multi-stage butterfly kernel `pallas_kernels.multistage` (:286) and the
per-stage kernels `butterfly_stage2` (:368).

Three routes, by size (`route_for`):

- local (n <= LOCAL_MAX): one `butterfly` call, bit reversal on the way
  in, every radix-2 DIT stage, natural order out; the plan's scale applied
  by one multiply by a constant.
- four-step (LOCAL_MAX < n <= DIRECT_ABOVE): a Bailey split n = n1 * n2
  with natural order in and out: n1-point transforms down the columns of
  A[i1, i2] (i = i1*n2 + i2), one elementwise multiply by the panel
  w^(k1*i2), n2-point transforms along the rows, the result written as
  X[k1 + n1*k2].  The plan's scale (n^-1 for the inverse, R^-1 for the
  standard-form LDE) is folded into that panel.
- direct (n > DIRECT_ABOVE, or where the four-step's row size would pass
  LOCAL_MAX): the JAX package's Pallas branch (:528-558): bit reversal
  (one gather), `butterfly` over the contiguous LOCAL_MAX-point blocks of
  the bit-reversed array (stages m < LOCAL_MAX, input already reversed),
  then the remaining stages m = LOCAL_MAX, ..., n/2 in place, grouped into
  passes of at most PASS_DEPTH consecutive stages (`stage_passes`: as few
  passes as that allows, their depths as equal as they can be), one
  `butterfly_stages` launch each, then the scale by one multiply by a
  constant.  Stage m reads w^(j*n/2m) from the table [n/2, L] of the n-th
  root, element-major (one twiddle is L contiguous limbs), built on the
  device by one kernel-6 `outer_table` from a factored pair (outer powers of
  w^s, inner powers of w), as the prover builds its long power tables: the
  host computes O(sqrt n) powers, not n/2.

Every multiply is the field's public `mont_mul` (kernel 5 on the card).

LOCAL_MAX is the port's own threshold: kernel 8 keeps a whole local
transform of L x n int32 limbs and its L x n/2 twiddles in one block's
shared memory, and 2048 points at L = 16 are 192 KB of the 227 KB a block
may have (kernels.butterfly_max_n).  PASS_DEPTH is the port's own too: a
pass of k stages keeps 2^k x 16 elements in shared memory (64 KB at L = 16
and k = 6), so the 11 stages above LOCAL_MAX of a 2^22-point transform take
2 launches (6 + 5 stages) and the 13 of a 2^24-point one 3 (5 + 4 + 4).
DIRECT_ABOVE is the JAX package's own (`_four_step_local`): above 2^21
points the four-step's O(n) panel is GB-scale, so the large transforms
take the stage kernels; on the card the direct route also needs no
host-built panel.  On one H100 the direct route is the faster one at 2^22
points since the stages run in fused passes (PERF.md §6).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..field.limbs import ints_to_limbs, power_series_mont_np

LOCAL_MAX = 2048
PASS_DEPTH = 6
DIRECT_ABOVE = 1 << 21


def route_for(n: int) -> str:
    """"local", "four_step" or "direct" for an n-point transform (read
    from LOCAL_MAX and DIRECT_ABOVE when the plan is made)."""
    if n <= LOCAL_MAX:
        return "local"
    n1 = 1 << ((n.bit_length() - 1) // 2)
    if n > DIRECT_ABOVE or n // n1 > LOCAL_MAX:
        return "direct"
    return "four_step"


def stage_passes(n: int, m: int, depth: int) -> list:
    """[(m_lo, k), ...]: the stages m, 2m, ..., n/2 of an n-point transform
    in as few passes of at most `depth` consecutive stages as there can be,
    their depths as equal as they can be (deeper passes first)."""
    stages = n.bit_length() - m.bit_length()
    count = -(-stages // depth)
    passes = []
    for i in range(count):
        k = stages // count + (1 if i < stages % count else 0)
        passes.append((m, k))
        m <<= k
    return passes


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
    """Device tables for one (field, n, root, scale), by route: the local
    roots' half-tables ([L, m/2], Montgomery powers of the m-th root); the
    four-step panel (scale folded in); for the direct route the stage
    table [n/2, L] (element-major), the bit-reversal index and the stage
    passes (read from LOCAL_MAX and PASS_DEPTH when the plan is made); the
    scale as a constant where it is not folded."""

    def __init__(self, field, dev, n: int, root: int, scale: int = 1):
        if n < 2 or n & (n - 1):
            raise ValueError(f"transform size {n} is not a power of two >= 2")
        params = field.params
        p = field.modulus
        root %= p
        scale %= p
        half = lambda w, m: dev.from_numpy(power_series_mont_np(params, w, m // 2))
        self.n = n
        self.route = route_for(n)
        self.split = self.panel = self.scale = self.twiddles = self.bitrev = None
        self.passes = []
        if self.route == "four_step":
            n1 = 1 << ((n.bit_length() - 1) // 2)
            n2 = n // n1
            self.split = (n1, n2)
            self.tables = (half(pow(root, n2, p), n1), half(pow(root, n1, p), n2))
            self.panel = dev.from_numpy(_panel_np(params, root, n1, n2, scale))
            return
        if scale != 1:
            self.scale = dev.const(scale, shape=(1,))
        if self.route == "local":
            self.tables = (half(root, n),)
            return
        # direct: w^k for k < n/2 as outer powers of w^s times inner powers of w
        ln = n // 2
        s = 1 << ((ln.bit_length() - 1) // 2)
        self.twiddles = dev.outer_table(
            dev.from_numpy(power_series_mont_np(params, pow(root, s, p), ln // s)),
            dev.from_numpy(power_series_mont_np(params, root, s))).t().contiguous()
        # the local root w^(n/LOCAL_MAX)'s half-table is every (n/LOCAL_MAX)-th entry
        self.tables = (self.twiddles[::n // LOCAL_MAX].t().contiguous(),)
        self.bitrev = _bitrev(n, dev.device)
        self.passes = stage_passes(n, LOCAL_MAX, PASS_DEPTH)


# ------------------------------------------------------------ plain version
def _bitrev(n: int, device) -> torch.Tensor:
    """The bit-reversal permutation of 0..n-1 (int64, on `device`)."""
    bits = n.bit_length() - 1
    idx = torch.arange(n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def butterfly_ref(dev, x: torch.Tensor, table: torch.Tensor,
                  out: torch.Tensor = None, bitrev_in: bool = False) -> torch.Tensor:
    """Plain kernel 8: x [B, G, L, n] (any strides) -> the n-point
    transform of each of the B*G rows over the root whose half-table is
    `table` [L, n/2], into `out` [B, G, L, n] (x itself, or not overlapping
    x) or a new contiguous tensor.  Natural order in, or already
    bit-reversed with `bitrev_in` (the contract of the JAX package's
    `multistage`).  The JAX package's jnp stage loop on bit-reversed input,
    with the plain field's ops (`*_ref`), so on the card it launches no
    kernel of the port."""
    B, G, L, n = x.shape
    T = B * G
    y = x.permute(2, 0, 1, 3).reshape(L, T, n)
    if not bitrev_in:
        y = y[:, :, _bitrev(n, x.device)]
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


def butterfly_stage_ref(dev, x: torch.Tensor, table: torch.Tensor, m: int) -> torch.Tensor:
    """One radix-2 DIT stage of half-size m over x [B, L, n], in place
    (returns x): butterfly j of group g takes lo at g*2m + j and hi at
    g*2m + m + j to lo + w*hi, lo - w*hi with w = table[j * n/2m], table
    [n/2, L] the n-th root's powers, element-major.  The JAX package's jnp
    stage (ntt/__init__.py:560-577) on the plain field ops."""
    B, L, n = x.shape
    y = x.view(B, L, n // (2 * m), 2, m).permute(1, 0, 2, 3, 4)     # [L, B, g, 2, m]
    lo, hi = y[:, :, :, 0], y[:, :, :, 1]
    tw = table.reshape(m, n // (2 * m), L)[:, 0].t()                 # [L, m]
    t = dev.mont_mul_ref(hi, tw[:, None, None, :])
    new_lo, new_hi = dev.add_ref(lo, t), dev.sub_ref(lo, t)
    lo.copy_(new_lo)
    hi.copy_(new_hi)
    return x


def butterfly_stages_ref(dev, x: torch.Tensor, table: torch.Tensor, m: int,
                         k: int) -> torch.Tensor:
    """Plain kernels 7 and 9: the k stages of half-size m, 2m, ...,
    2^(k-1) m over x [B, L, n] in place (returns x), one
    butterfly_stage_ref each; table [n/2, L] as there."""
    for j in range(k):
        butterfly_stage_ref(dev, x, table, m << j)
    return x


# ------------------------------------------------------------ the wrappers
def butterfly(dev, x: torch.Tensor, table: torch.Tensor, out: torch.Tensor = None,
              bitrev_in: bool = False) -> torch.Tensor:
    """Local transforms (contract of butterfly_ref).  CPU tensors run the
    plain version; CUDA tensors launch kernel 8 or raise."""
    if x.device.type == "cpu":
        return butterfly_ref(dev, x, table, out, bitrev_in)
    return kernels.butterfly(dev, x, table, out, bitrev_in)


def butterfly_stages(dev, x: torch.Tensor, table: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """k stages in place in one pass (contract of butterfly_stages_ref).
    CPU tensors run the plain version; CUDA tensors launch kernel 7 (lowest
    m <= 4096) or 9, or raise."""
    if x.device.type == "cpu":
        return butterfly_stages_ref(dev, x, table, m, k)
    return kernels.butterfly_stages(dev, x, table, m, k)


def _run(dev, a: torch.Tensor, plan: Radix2Plan, bfly, stages, mul) -> torch.Tensor:
    n = plan.n
    L = a.shape[-2]
    batch_shape = tuple(a.shape[:-2])
    x = a.reshape((-1, L, n))
    B = x.shape[0]
    if plan.route == "four_step":
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
    if plan.route == "local":
        y = bfly(dev, x[:, None], plan.tables[0])[:, 0]             # [B, L, n]
    else:
        # direct: the bit-reversed copy is the working array, updated in
        # place by the local pass and every stage (no second n-sized buffer)
        local = 2 * plan.tables[0].shape[1]
        y = x.index_select(2, plan.bitrev)
        blocks = y.view(B, L, n // local, local).permute(0, 2, 1, 3)
        bfly(dev, blocks, plan.tables[0], out=blocks, bitrev_in=True)
        for m, k in plan.passes:
            stages(dev, y, plan.twiddles, m, k)
    if plan.scale is not None:
        y = mul(y.transpose(0, 1), plan.scale).transpose(0, 1)
    return y.reshape(batch_shape + (L, n))


def transform(dev, a: torch.Tensor, plan: Radix2Plan) -> torch.Tensor:
    """a [..., L, n] -> [..., L, n]: the plan's scale times the transform,
    natural order in and out.  CPU tensors run the plain versions; CUDA
    tensors launch kernels 8 and 5 (and 7, 9 on the direct route)."""
    return _run(dev, a, plan, butterfly, butterfly_stages, dev.mont_mul)


def transform_ref(dev, a: torch.Tensor, plan: Radix2Plan) -> torch.Tensor:
    """The same transform from plain versions only, on any device."""
    return _run(dev, a, plan, butterfly_ref, butterfly_stages_ref, dev.mont_mul_ref)
