"""The card's ceiling probes: the Montgomery-multiply rate at each limb count
(kernel 10, `mont_chain`) and the u32 op rate (kernel 11, `u32_chain`).

Counterparts of the JAX package's `scripts/roofline.py` (`_mont_chain_kernel`
:78, `bench_mont_rate` :111) and `scripts/vpu_bound.py` (`_kernel` :24,
`main` :37), copied here because the port imports nothing of them.  The u32 rate
is the card's integer-op rate that the bounds of the field and hash kernels
divide by: a hash counts its u32 ops, a Montgomery product the least
number of 32-bit multiplies any schedule needs (`mont_min_u32_ops`).  The
Montgomery rate is that of this code's own product, `field.cuh`'s word
product (`mont_mul_w`), so it says how far the product is from the card,
not what the card can do.  The chain squares (v <- v*v, the JAX probe's
chain), and one chain gives the rate of every field kernel's product: on
the word product a square shares no work with a general product, since
every step is the same PTX carry chains in `asm volatile`, which the
compiler neither merges nor reorders.  Bytes over the card's memory rate
is the other bound.

`mont_chain` and `u32_chain` run their plain versions on CPU tensors and
launch their kernels (csrc/probes.cu) on CUDA tensors, or raise.  The rate
functions need a CUDA device and time with CUDA events.
"""

from __future__ import annotations

import torch

from . import kernels

U32_CHAIN_K = 512                       # chained ops per element (vpu_bound.K)
U32_OPS_PER_ELEMENT = (U32_CHAIN_K // 4) * 5   # counted as vpu_bound counts them
U32_DEPENDENT_PER_ROUND = (U32_CHAIN_K // 4) * 4   # add, xor, rotate, add: the chain
_MASK32 = 0xFFFFFFFF


def mont_min_u32_ops(L: int) -> int:
    """The least 32-bit multiplies of one Montgomery product of L 16-bit
    limbs held as k = L/2 32-bit words (CIOS): k^2 word products for a*b
    and k^2 for m*p, each a low and a high half, plus k low halves for the
    per-word quotient m: 4k^2 + k."""
    k = (L + 1) // 2
    return 4 * k * k + k


# ------------------------------------------------------------ plain versions
def mont_chain_ref(dev, x: torch.Tensor, depth: int) -> torch.Tensor:
    """x [L, n] (Montgomery limbs) squared `depth` times, each step one
    Montgomery product of the element with itself (plain field ops)."""
    v = x
    for _ in range(depth):
        v = dev.mont_mul_ref(v, v)
    return v.to(torch.int32)


def u32_chain_ref(x: torch.Tensor, rounds: int = 1) -> torch.Tensor:
    """vpu_bound._kernel's chain on u32 words held in int32, in int64 with
    32-bit masks, `rounds` times."""
    v = x.to(torch.int64) & _MASK32
    w = v ^ 0x9E3779B9
    for _ in range(rounds * (U32_CHAIN_K // 4)):
        v = (v + w) & _MASK32
        v = v ^ (w >> 7)
        v = ((v >> 16) | (v << 16)) & _MASK32
        w = (w + v) & _MASK32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


# ------------------------------------------------------------ the wrappers
def mont_chain(dev, x: torch.Tensor, depth: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return mont_chain_ref(dev, x, depth)
    return kernels.mont_chain(dev, x, depth)


def u32_chain(x: torch.Tensor, rounds: int = 1) -> torch.Tensor:
    if x.device.type == "cpu":
        return u32_chain_ref(x, rounds)
    return kernels.u32_chain(x, rounds)


# ------------------------------------------------------------ the rates
def event_ms(fn, reps: int = 5) -> float:
    """Mean device milliseconds of fn() over `reps` back-to-back calls,
    after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mont_rate(dev, n: int = 1 << 21, d1: int = 16, d2: int = 64, reps: int = 5) -> dict:
    """Montgomery products per second at dev.L limbs, from the slope
    between chain depths d1 and d2 over n elements (the fixed memory
    traffic and launch cost cancel), as `bench_mont_rate` measures it."""
    if dev.device.type != "cuda":
        raise RuntimeError("mont_rate measures a CUDA device")
    x = dev.from_numpy(dev.params.r2_limbs).reshape(dev.L, 1).expand(dev.L, n).contiguous()
    t1 = event_ms(lambda: kernels.mont_chain(dev, x, d1), reps)
    t2 = event_ms(lambda: kernels.mont_chain(dev, x, d2), reps)
    return {"L": dev.L, "n": n, "depths": (d1, d2), "ms": (t1, t2),
            "mont_muls_per_s": (d2 - d1) * n / ((t2 - t1) * 1e-3)}


def u32_rate(device, n: int = 1 << 26, reps: int = 5) -> dict:
    """u32 ops per second of the vpu_bound chain over n words, counted as
    U32_OPS_PER_ELEMENT per word; its bytes (8n) are well under the op
    time at this n."""
    if torch.device(device).type != "cuda":
        raise RuntimeError("u32_rate measures a CUDA device")
    x = torch.arange(n, dtype=torch.int32, device=device)
    ms = event_ms(lambda: kernels.u32_chain(x), reps)
    return {"n": n, "ms": ms, "u32_ops_per_s": n * U32_OPS_PER_ELEMENT / (ms * 1e-3)}


def u32_latency(device, r1: int = 64, r2: int = 1024, reps: int = 5) -> dict:
    """Seconds of one dependent u32 op on the card: the u32 chain on one
    element (one thread), the slope between `r1` and `r2` rounds of
    U32_DEPENDENT_PER_ROUND dependent ops (the launch cost cancels).  A
    one-thread or one-block kernel's chain length times it is that
    kernel's latency floor."""
    if torch.device(device).type != "cuda":
        raise RuntimeError("u32_latency measures a CUDA device")
    x = torch.ones(1, dtype=torch.int32, device=device)
    t1 = event_ms(lambda: kernels.u32_chain(x, r1), reps)
    t2 = event_ms(lambda: kernels.u32_chain(x, r2), reps)
    return {"rounds": (r1, r2), "ms": (t1, t2),
            "s_per_op": (t2 - t1) * 1e-3 / ((r2 - r1) * U32_DEPENDENT_PER_ROUND)}
