"""One digit-matmul DFT level: kernel 1 of the port and its plain version.

Counterpart of ``genstark_tpu/ntt/mxu.py``.  A level computes, for a batch
of `cols` length-m columns,

    out[k, col] = (sum_j W[k, j] * x[j, col]) * w_l^(k * (col % rest))  mod p

with W = scale * root^(k*j).  W and x arrive as D = 2L+1 balanced base-256
int8 digit planes (17 for p128, 5 for p32), so the D^2 digit products sum
exactly in int32 into 2D-1 diagonals (|S_k| <= D * m * 2^14 < 2^30 for
m <= 2048).  The epilogue recombines the diagonals into one wide integer
(biased by 2^30 per diagonal; a precomputed constant cancels the bias mod
p) and reduces it mod p.  The level twiddle is none (rest == 1), a direct
panel P[k, c] = w_l^(k*c) for c < rest, or a factored pair
A[h, k] = w_l^(k*h*s), B[k, t] = w_l^(k*t).  The output is canonical limbs,
or their int8 digit planes for the next level.

Every output value is the canonical residue, so the CUDA kernel
(csrc/dft_level.cu), the plain torch version below and the JAX package's
``_run_dft_level_ref`` agree bit for bit even though their reductions take
different routes: the JAX epilogue folds by a static solinas bound, this
port reduces the wide integer in L-limb chunks by Montgomery multiplies
against 2^(16Lj)*R mod p (the route the JAX epilogue already takes for
p32) followed by modular adds.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..field.device import DeviceField
from ..field.limbs import LIMB_BITS, LIMB_MASK, int_to_limbs, power_series_mont_np

DIGIT_BITS = 8
BIAS = 1 << 30               # |S_k| <= D * m * 2^14 < 2^30 for m <= 2048
MAX_M = 2048                 # int32-accumulator + bias bound (see above)


@lru_cache(maxsize=None)
def solinas_spec(modulus: int):
    """(L 16-bit limbs, D signed base-256 digits, n_diags, u, a) for a
    modulus p = 2^(16L) - t with t + 1 = u * 2^(16a), u < 2^16, else None
    (copy of the JAX package's ``ntt/mxu.py`` solinas_spec: p128 and p32)."""
    eb = (modulus.bit_length() + 7) // 8
    if eb % 2 or (1 << (8 * eb)) < modulus:
        return None
    L = eb // 2
    t = (1 << (16 * L)) - modulus
    if t <= 0:
        return None
    tp = t + 1
    a = 0
    while tp % (1 << 16) == 0 and tp:
        tp >>= 16
        a += 1
    if tp >= (1 << 16):
        return None
    D = eb + 1
    return L, D, 2 * D - 1, tp, a


# ------------------------------------------------------------ host builders
@lru_cache(maxsize=None)
def _w_digits_np(modulus: int, m: int, root: int, scale: int) -> np.ndarray:
    """int8[D, m, m]: balanced base-256 digit planes of the (scaled) DFT
    matrix W[r, c] = scale * root^(r*c) mod p (copy of the JAX builder)."""
    L, D, _, _, _ = solinas_spec(modulus)
    eb = 2 * L
    tab = np.zeros((m, eb), dtype=np.uint8)
    cur = scale % modulus
    for j in range(m):
        tab[j] = np.frombuffer(cur.to_bytes(eb, "little"), dtype=np.uint8)
        cur = (cur * root) % modulus
    r = np.arange(m, dtype=np.int64)
    E = (r[:, None] * r[None, :]) % m                   # exponent mod m
    bytes_ = tab[E]                                     # [m, m, eb] u8
    digs = np.zeros((D, m, m), dtype=np.int8)
    carry = np.zeros((m, m), dtype=np.int16)
    for i in range(eb):
        t = bytes_[:, :, i].astype(np.int16) + carry
        ge = t >= 128
        digs[i] = (t - ge * 256).astype(np.int8)
        carry = ge.astype(np.int16)
    digs[eb] = carry.astype(np.int8)
    return digs


@lru_cache(maxsize=None)
def bias_correction(modulus: int, copies: int = 1) -> np.ndarray:
    """u32[L] limbs of (-copies * BIAS * sum_k 2^(8k)) mod p: adding this
    to a recombination that biased every diagonal `copies` times cancels
    the bias exactly mod p (kernel 1 biases each staged slice of j)."""
    L, _, nd, _, _ = solinas_spec(modulus)
    total = copies * BIAS * sum(1 << (8 * k) for k in range(nd))
    return int_to_limbs((-total) % modulus, L)


def _panel_grid_np(params, seed: int, rows: int, cols: int) -> np.ndarray:
    """[L, rows, cols] Montgomery grid g[k, t] = seed^(k*t), host-built."""
    p = params.modulus
    out = np.zeros((params.L, rows, cols), dtype=np.uint32)
    cur = 1
    for k in range(rows):                  # row k = power series of seed^k
        out[:, k, :] = power_series_mont_np(params, cur, cols)
        cur = (cur * seed) % p
    return out


def _direct_panel_np(params, seed: int, rows: int, rest: int,
                     Tc: int = None) -> np.ndarray:
    """[L, rows, Tc] direct twiddle panel g[k, t] = seed^(k * (t % rest)):
    the period-`rest` pattern tiled to Tc columns (rest | Tc; Tc = rest by
    default — the kernel reads column col % rest)."""
    small = _panel_grid_np(params, seed, rows, rest)
    return np.tile(small, (1, 1, (Tc or rest) // rest))


def _n_lazy(nd: int) -> int:
    """Lazy 16-bit limbs that hold the biased diagonal recombination."""
    return (DIGIT_BITS * (nd - 1) + 31) // LIMB_BITS + 2


@lru_cache(maxsize=None)
def epilogue_constants(modulus: int):
    """(corr u32[L], chunk constants u32[n_ch - 1, L]): the bias correction
    and, for chunk j >= 1 of the reduced wide integer, 2^(16Lj) * R mod p
    (Montgomery-multiplying a chunk by it gives chunk * 2^(16Lj) mod p)."""
    L, _, nd, _, _ = solinas_spec(modulus)
    n_strict = _n_lazy(nd) + 2
    n_ch = -(-n_strict // L)
    R = 1 << (16 * L)
    consts = [int_to_limbs(pow(2, 16 * L * j, modulus) * R % modulus, L)
              for j in range(1, n_ch)]
    return bias_correction(modulus), np.stack(consts).astype(np.uint32)


def w_digits(field, m: int, root: int, scale: int = 1) -> np.ndarray:
    if solinas_spec(field.modulus) is None:
        raise NotImplementedError(
            "the digit DFT needs a solinas-foldable modulus (p32, p128)")
    if m > MAX_M:
        raise ValueError(f"m={m} exceeds the int32 accumulator bound ({MAX_M})")
    return _w_digits_np(field.modulus, m, root % field.modulus,
                        scale % field.modulus)


# ------------------------------------------------------------ plain version
def encode_digits(x: torch.Tensor) -> torch.Tensor:
    """int32[L, ...] canonical 16-bit limbs -> int8[2L+1, ...] balanced
    base-256 digits (x = sum d_i 256^i, top digit in {0, 1})."""
    digs = []
    c = torch.zeros_like(x[0], dtype=torch.int32)
    for t in range(x.shape[0]):
        limb = x[t].to(torch.int32)
        for half in range(2):
            s = ((limb >> (8 * half)) & 0xFF) + c
            ge = s >= 128
            digs.append(torch.where(ge, s - 256, s).to(torch.int8))
            c = ge.to(torch.int32)
    digs.append(c.to(torch.int8))
    return torch.stack(digs)


def _propagate(limbs, extra: int):
    """Lazy int64 limbs -> strict 16-bit limbs, `extra` limbs appended to
    hold the final carry."""
    out = []
    c = torch.zeros_like(limbs[0])
    for x in limbs:
        s = x + c
        out.append(s & LIMB_MASK)
        c = s >> LIMB_BITS
    for _ in range(extra):
        out.append(c & LIMB_MASK)
        c = c >> LIMB_BITS
    return out


def diags_to_limbs(dev: DeviceField, acc: torch.Tensor) -> torch.Tensor:
    """int64[2D-1, ...] signed digit-diagonal sums S_k -> canonical
    int32[L, ...] limbs of (sum_k S_k 2^(8k)) mod p.  The same steps as
    the kernel's epilogue (csrc/dft_level.cu)."""
    L = dev.L
    nd = acc.shape[0]
    corr, consts = epilogue_constants(dev.p)
    limbs = [torch.zeros_like(acc[0]) for _ in range(_n_lazy(nd))]
    for j in range(L):
        limbs[j] = limbs[j] + int(corr[j])
    for k in range(nd):
        v = acc[k] + BIAS                                   # in [0, 2^31)
        for part, extra_bits in ((v & LIMB_MASK, 0), (v >> LIMB_BITS, LIMB_BITS)):
            bit = k * DIGIT_BITS + extra_bits
            pidx, off = bit // LIMB_BITS, bit % LIMB_BITS
            sh = part << off                                # <= 24 bits
            limbs[pidx] = limbs[pidx] + (sh & LIMB_MASK)
            limbs[pidx + 1] = limbs[pidx + 1] + (sh >> LIMB_BITS)
    strict = _propagate(limbs, extra=2)
    strict += [torch.zeros_like(strict[0])] * (-len(strict) % L)
    # chunk 0 < 2^(16L) < 2p: one conditional subtract makes it canonical
    out = dev._cond_sub_p(strict[:L], torch.zeros_like(strict[0]))
    shape = (L,) + (1,) * (acc.dim() - 1)
    for j in range(1, len(strict) // L):
        c_j = dev.from_numpy(consts[j - 1]).reshape(shape)
        red = dev.mont_mul_ref(torch.stack(strict[L * j:L * (j + 1)]), c_j)
        out = dev.add_ref(out, red)
    return out


def digit_planes(x: torch.Tensor, m: int) -> torch.Tensor:
    """A level's input as int8 digit planes [D, m, cols]: x is int8 digits
    or int32 canonical limbs (encoded by `encode_digits`), either as
    [planes, m, cols] or as the transform's view [planes, pre, m, r], whose
    column (b, q) is col = b * r + q."""
    if x.dim() == 4:
        x = x.permute(0, 2, 1, 3).reshape(x.shape[0], m, x.shape[1] * x.shape[3])
    return x if x.dtype == torch.int8 else encode_digits(x)


def run_dft_level_ref(dev: DeviceField, w8: torch.Tensor, x8: torch.Tensor,
                      m: int, rest: int, tw, out_digits: bool = False) -> torch.Tensor:
    """Plain torch level: same contract and values as the kernel.

    w8 int8[D, m, m]; x8 the input in any form `digit_planes` takes (int8
    digits or int32 limbs, [planes, m, cols] or [planes, pre, m, r]); tw
    None, {"p": panel [L, m, Tc]} or {"a": A [rest//s, L, m], "b": B
    [L, m, s]} (int32 Montgomery).  Returns int32[L, m, cols] or, with
    out_digits, int8[D, m, cols].

    All D x D digit-plane products run as ONE float64 matrix product
    (exact: every partial sum is below m * 2^14 < 2^53).  The field
    arithmetic is the plain field's (`mont_mul_ref`, `add_ref`), so on the
    card this launches no kernel of the port."""
    L = dev.L
    D = 2 * L + 1
    x8 = digit_planes(x8, m)
    cols = x8.shape[2]
    W = w8.to(torch.float64).reshape(D * m, m)
    X = x8.to(torch.float64).permute(1, 0, 2).reshape(m, D * cols)
    P = (W @ X).reshape(D, m, D, cols)                 # P[i, k, j, col]
    acc = torch.zeros((2 * D - 1, m, cols), dtype=torch.float64, device=x8.device)
    for i in range(D):
        acc[i:i + D] += P[i].permute(1, 0, 2)
    out = diags_to_limbs(dev, acc.to(torch.int64))     # [L, m, cols]
    if rest > 1:
        if "p" in tw:
            ov = out.reshape(L, m, cols // rest, rest)
            ov = dev.mont_mul_ref(ov, tw["p"][:, :, None, :rest])
        else:
            A = tw["a"].permute(1, 2, 0)               # [h, L, m] -> [L, m, h]
            Bt = tw["b"]
            s = Bt.shape[-1]
            ov = out.reshape(L, m, cols // rest, rest // s, s)
            ov = dev.mont_mul_ref(ov, A[:, :, None, :, None])
            ov = dev.mont_mul_ref(ov, Bt[:, :, None, None, :])
        out = ov.reshape(L, m, cols)
    return encode_digits(out) if out_digits else out


# ------------------------------------------------------------ the wrapper
def run_dft_level(dev: DeviceField, w8: torch.Tensor, x8: torch.Tensor,
                  m: int, rest: int, tw, out_digits: bool = False) -> torch.Tensor:
    """One DFT level (contract of run_dft_level_ref: digits or limbs in,
    flat or as the transform's strided view).  CPU tensors run the plain
    version; CUDA tensors launch kernel 1 or raise."""
    if m > MAX_M or m & (m - 1):
        raise ValueError(f"level size {m} must be a power of two <= {MAX_M}")
    if x8.device.type == "cpu":
        return run_dft_level_ref(dev, w8, x8, m, rest, tw, out_digits)
    return kernels.dft_level(dev, w8, x8, m, rest, tw, out_digits)
