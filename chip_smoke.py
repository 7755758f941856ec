"""Chip smoke test of the PyTorch port: builds the CUDA kernels (the field
kernels on field.cuh's one word product with no register spill), checks
each against its plain torch version on the card, the field kernels at
every limb count (L = 2, 4, 6, 8, 10, 12, 14, 16) with 0, 1 and p - 1
among their inputs (and the batched
inverse, built on kernel 5, against its plain version), and every kernel
of the large paths at their largest shapes (MiMC-256 at Ne = 2^24, L = 16,
with kernel 1 at every level of the 2^22- and 2^24-point LDEs; MiMC-128 at
Ne = 2^25, L = 8, with kernel 1 at every level of the 2^24- and 2^25-point
LDEs and of the 2^20- and 2^21-point iNTTs; MiMC over P64 at Ne = 2^22, L =
4, with kernel 8 and the stage passes); times the P256 LDE transforms of
2^22 and 2^24 points on the digit route and on the radix-2 route; measures the card's
ceilings with the two probe kernels; proves the pinned toy proofs (the
division AIR among them, and MiMC over 2^64 - 2^32 + 1 and the solinas
moduli of 96, 160 and 192 bits, kernel 1 at L = 4, 6, 10 and 12),
the bench configuration (MiMC-128, 2^13 steps, secret input 3), MiMC-256 at
2^13, 2^18 and 2^20 steps (the digit route at L = 16, as the JAX package
routes every solinas field), MiMC over P64 at 2^18 steps (the large-domain
radix-2 path: the direct route with the stage kernels, one-fetch, staged
and four-step), MiMC over the solinas moduli of 96, 160 and 192 bits at
2^18 steps (the digit route at L = 6, 10 and 12: one-fetch, staged, and
forced onto the radix-2 route, all one proof; the 192-bit one against the
port's CPU pin, after every kernel at its shapes and its 2^22-point LDE on
both routes), MiMC-128 up the JAX package's ladder on the digit route (2^17
steps against the port's CPU pin; 2^20 steps, the north star, whose
one-fetch, staged and sharded proofs must agree; 2^21 steps, Ne = 2^25, five
DFT levels of 32), the reference's Rescue and Poseidon Merkle-proof
configurations at depth 16 and the lib224-import Merkle proof, each
compiled from its AirScript source, and its elliptic-curve point
multiplication, compiled from AirAssembly, and the reference's fibonacci
(2^17 steps) and static-variables demos, each with its trace from the
native generator; proves five of these and MiMC-128 at 2^20 steps again
with the staged prover (`prove_staged`), whose bytes must equal the
one-fetch prove's, with no plain version called; runs the public ntt /
intt / low_degree_extend at the staged paths' sizes against the plain path,
and times the public ntt of 2^20 p128 points (butterflies a second); proves
the bench, MiMC-256 at 2^18 steps and MiMC-128 at 2^20 steps with the
sharded prover (protocol/sharded.py) over four ranks that share the card
over gloo, spawned by parallel/launch.run_ranks (every rank's bytes equal
to the pin or to the one-fetch proof, every kernel of the sharded path held
against its plain version at the shard shapes, distributed_ntt /
distributed_intt at 2^17, 2^22 and 2^24 points against the single-device
ntt), and the bench over one nccl rank (a one-rank mesh calls every
collective, so NCCL runs each on the card); parses, re-serializes and
verifies every proof it makes with the port's verifier; counts the
synchronizing calls of one warm prove on every path (one, the proof's
fetch, after the prove's first kernel) and requires every proof to come out
of the device-sampled one-fetch path; and prints one JSON line per contract
at the end.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc).  Imports nothing of JAX
or the JAX package.  Exits non-zero, printing no result, on any failure.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

# The pins and the step counts and options they are made at, and the
# instruments the tests and scripts share, live in genstark_tpu_torch.testing.
from genstark_tpu_torch.testing import (
    BENCH_PIN, BENCH_STEPS, DEMO_MODULUS, DEMO_PIN, DEMO_STEPS, DIV_PIN, DRAM_SETS, FIB_PIN,
    FIB_STEPS, GOLDILOCKS_64_PIN, LADDER_17_PIN, LARGE_PIN, LARGE_STEPS, LIB224_PIN,
    MEM_BYTES_PER_S, MIMC64_18_PIN, MIMC192_18_PIN, MIMC256_PIN, P32_PIN, P64_64_PIN, P128_PIN,
    P256_64_PIN, POINTMUL_PIN, POSEIDON16_PIN, RESCUE16_PIN, SOLINAS96_64_PIN,
    SOLINAS160_64_PIN, SOLINAS192_64_PIN, TOY, candidates_needed, count_syncs, device_ms,
    in_turn, is_port_kernel, odd_hex_roots, plain_level, profile_run, ptxas_report,
    random_elements, word_kernels)

HERE = os.path.dirname(os.path.abspath(__file__))


# Kernels the bench, each MiMC-128 and MiMC-256 path (the digit route: P256
# takes it at every size, as the JAX package routes every modulus its
# solinas_spec takes) and their sharded ranks must launch.
BENCH_KERNELS = ("dft_level", "hash_words", "hash_limbs", "lcomb_tail", "field_ew",
                 "outer_table", "sample_queries")
# One more rung at 2^20 steps (Ne = 2^24): no pin; each kernel it launches is
# held against its plain version at its largest shapes, and three proves
# must agree.
LARGEST_STEPS = 2 ** 20
# The direct route's transform size on the 2^18-step path (Ne).
LARGE_N = 2 ** 22
# MiMC-128 (the bench's AIR, options and secret input over p128) up the JAX
# package's proof ladder (BENCH_r05_ladder.json: 2^13, 2^17, 2^20 and 2^21
# steps), every transform on the digit route (kernel 1).  2^17 steps (Ne =
# 2^21) against LADDER_17_PIN; 2^20 steps (Ne = 2^24, four levels of 64),
# the project's north star, whose one-fetch, staged and sharded proofs must
# agree; 2^21 steps (Ne = 2^25, five levels of 32), the ladder's top, whose
# three proves must agree.
LADDER_STEPS = (2 ** 17, 2 ** 20, 2 ** 21)
# The sharded prover (protocol/sharded.py) over ranks spawned by
# parallel/launch.py: SHARDED_RANKS ranks sharing the one card over gloo
# prove the bench and MiMC-256 at 2^18 steps, each against its pin, and
# MiMC-128 at 2^20 steps against the one-fetch prove's bytes of the same
# call (pin None); one rank over nccl proves the bench.  (label, steps,
# modulus name, pin, kernels the path must launch on every rank: its
# transforms are local ones of at most 4096 points, kernel 1's levels on
# every path.)
SHARDED_RANKS = 4
SHARDED_TIMEOUT_S = 600.0
SHARDED_PATHS = (("bench", 2 ** 13, "P128", BENCH_PIN, BENCH_KERNELS),
                 ("mimc256-2^18", LARGE_STEPS, "P256", LARGE_PIN, BENCH_KERNELS),
                 ("mimc128-2^20", 2 ** 20, "P128", None, BENCH_KERNELS))
# distributed_ntt / distributed_intt against the single-device ntt
DIST_NTT_SIZES = (("P128", 2 ** 17), ("P256", LARGE_N), ("P128", 2 ** 24))
# The collectives every sharded prove must call on every rank (Mesh.traffic's
# names: all_to_all_single with equal blocks and with the FRI transpose's
# splits), on either backend.
COLLECTIVES = {"all_to_all_single", "all_to_all_single splits", "all_gather", "all_reduce"}
# H100 SXM NVLink 4, GB/s a direction (data sheet): only the analytic
# split's projection for four cards reads it.
NVLINK_GBPS = 450.0

# Kernels each other main path must launch.  MiMC over P64 at 2^18 steps
# keeps the direct radix-2 route (kernels 8, 7 and 9), where the JAX package
# also runs its radix-2 kernels.
RADIX2_LARGE_KERNELS = ("bfly_stage", "bfly_stage_split", "butterfly", "field_ew",
                        "outer_table", "hash_words", "hash_limbs", "lcomb_tail",
                        "sample_queries")
# A path runs one transform route: one that requires kernel 1 launches none
# of these, one that requires kernel 8 launches no kernel 1.
RADIX2_KERNELS = ("butterfly", "bfly_stage", "bfly_stage_split")
PROBE_KERNELS = ("mont_chain", "u32_chain")


# The Merkle paths (p128) and the P224 paths (lib224-merkle-8, pointmul).
MERKLE_KERNELS = ("dft_level", "hash_words", "hash_limbs", "lcomb_tail", "field_ew",
                  "sample_queries")
# the division AIR's constraint divides by a register: its proves run inv,
# whose total is inverted by kernel A
DIV_KERNELS = ("dft_level", "hash_words", "field_ew", "sample_queries", "mont_inv")
FIB_KERNELS = ("dft_level", "hash_words", "hash_limbs", "lcomb_tail", "field_ew",
               "outer_table", "sample_queries")
DEMO_KERNELS = ("butterfly", "hash_words", "hash_limbs", "lcomb_tail", "field_ew",
                "sample_queries")
# The staged prover forms every table by power_series and every field op on
# kernel 5, commits with kernels 2 and 3, and transforms with kernel 1 (the
# solinas fields) or kernel 8 (P64 and the demo field); it samples on the
# host, so no kernel B, and forms C(x) and L(x) without kernel 4.
STAGED_DIGIT = ("dft_level", "hash_words", "hash_limbs", "field_ew")
STAGED_RADIX2 = ("butterfly", "hash_words", "hash_limbs", "field_ew")
# The public ntt / intt / low_degree_extend at the staged paths' sizes:
# (modulus, trace length T, evaluation domain Ne).
NTT_SIZES = (("P32", FIB_STEPS, 4 * FIB_STEPS), ("P128", BENCH_STEPS, 16 * BENCH_STEPS),
             ("P256", BENCH_STEPS, 16 * BENCH_STEPS), (DEMO_MODULUS, DEMO_STEPS, 4 * DEMO_STEPS))
# The plain versions, which a prove on CUDA tensors must never call:
# (module, class or None, names).
PLAIN_VERSIONS = (
    ("genstark_tpu_torch.field.device", "DeviceField",
     ("mont_mul_ref", "add_ref", "sub_ref", "outer_table_ref", "mont_pow_ref", "inv_ref")),
    ("genstark_tpu_torch.hash", None, ("digest_rows_ref",)),
    ("genstark_tpu_torch.ntt.dft", None, ("run_dft_level_ref",)),
    ("genstark_tpu_torch.ntt.radix2", None,
     ("butterfly_ref", "butterfly_stage_ref", "butterfly_stages_ref", "transform_ref")),
    ("genstark_tpu_torch.protocol.lincomb_kernel", None, ("lcomb_tail_ref",)),
    ("genstark_tpu_torch.protocol.device_queries", None,
     ("sample_sets_ref", "sample_indexes_ref")),
)

# The card's dense int8 tensor-core rate (one multiply-add is 2 ops) for
# kernel 1's digit products (H100 SXM data sheet); its memory rate is
# testing.MEM_BYTES_PER_S.
INT8_OPS_PER_S = 1.979e15
# u32 ops per blake2s compression: 10 rounds of 8 G functions of 14 ops.
BLAKE2S_BLOCK_OPS = 10 * 8 * 14
# u32 ops per SHA-256 compression: 64 rounds of 24 (Sigma1 5, Ch 3, T1 4
# adds, Sigma0 5, Maj 5, 2 adds), 48 schedule words of 13 (sigma0 5, sigma1
# 5, 3 adds), 8 final adds.
SHA256_BLOCK_OPS = 64 * 24 + 48 * 13 + 8
# Dependent ops on the critical path of one SHA-256 round (kernel B's chain:
# Sigma1's rotations then their xor, the two adds into T1, the add into e).
SHA256_ROUND_CHAIN = 5
# Kernel A's binary GCD: u32 ops of one step (on the 64-bit a, b: both
# subtractions 4, the compare 2, the odd and swap tests 2, the selects 6,
# the shift 2; on the 32-bit factors: differences 2, negations 2, selects 6,
# doublings 2) and dependent ops on its chain (a subtraction 2, two selects,
# the shift); a batch's update of a, b, u, v on k words: u32 ops 24k + 16
# for the four, and on the chain the products' carries k + 1, the sum's k +
# 1, the shift or reduction k and the two shuffles: 3k + 4.
GCD_STEP_OPS, GCD_STEP_CHAIN = 28, 5


class SmokeFailure(Exception):
    pass


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def check_launches(label: str, launches: dict, required) -> None:
    """Every kernel of `required` launched, and the path ran one transform
    route: kernel 1 and no radix-2 kernel where it requires kernel 1, no
    kernel 1 where it requires kernel 8."""
    missing = [k for k in required if launches.get(k, 0) == 0]
    require(not missing, f"{label}: kernels of the path never launched: {missing}")
    other = RADIX2_KERNELS if "dft_level" in required else (
        ("dft_level",) if "butterfly" in required else ())
    stray = {k: launches[k] for k in other if launches.get(k, 0)}
    require(not stray, f"{label}: launched kernels of the other transform route: {stray}")


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, one warm-up)."""
    from genstark_tpu_torch.roofline import event_ms
    return event_ms(fn, reps)


def short_kernel_name(name: str) -> str:
    """gs::dft_level_kernel<8>(...) -> dft_level_kernel."""
    tail = name.split("gs::", 1)[1] if "gs::" in name else name
    for stop in "<( ":
        tail = tail.split(stop, 1)[0]
    return tail


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def max_abs_err(a, b) -> int:
    require(tuple(a.shape) == tuple(b.shape), f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def check_dft(dev, field, rng, results):
    """Kernel 1 at the levels of a 2^17-point transform (factored, direct
    and no twiddle), limbs and digits out, digits in; level 0 also with
    limbs in, as the transform's strided view (the main path's form); 0, 1
    and p - 1 among every level's inputs.  Run for every limb count kernel
    1 is built for.  At p128 the reported time is the main path's three
    levels (device time, and event means); beside it torch._int_mm on the
    stacked digit product of each level, a yardstick for the multiply-adds
    alone (it does not compute the level)."""
    import torch
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.ntt import DftPlan, dft
    from genstark_tpu_torch.testing import plant
    n = 2 ** 17
    plan = DftPlan(field, dev, n, field.get_root_of_unity(n), 1)
    rest = n
    err, k_ms, p_ms, d_ms, mm_ms = 0, 0.0, 0.0, 0.0, 0.0
    L = dev.L
    D = 2 * L + 1
    main = field.modulus.bit_length() == 128
    n_bytes, work = 0, []
    folds = solinas_fold_mults(field.modulus) if main else 0
    for lvl, m in enumerate(plan.levels):
        rest //= m
        cols = n // m
        x = dev.from_numpy(plant(field, random_elements(rng, field.modulus, L, m * cols),
                                 [0, 1, field.modulus - 1], 0)).reshape(L, m, cols)
        x8 = dft.encode_digits(x).contiguous()
        tw = plan.tws[lvl] if rest > 1 else None
        mode = "none" if tw is None else ("direct" if "p" in tw else "factored")
        # the transform's view of level 0's limbs: [L, pre = 1, m, rest]
        inputs = [("digits", x8)] + ([("limbs view", x.reshape(L, 1, m, cols))] if lvl == 0 else [])
        for out_digits in (False, True):
            want = dft.run_dft_level_ref(dev, plan.w8s[lvl], x8, m, rest, tw, out_digits)
            pm = cuda_ms(lambda: dft.run_dft_level_ref(dev, plan.w8s[lvl], x8, m, rest, tw,
                                                       out_digits), reps=2)
            for kind, xin in inputs:
                args = (dev, plan.w8s[lvl], xin, m, rest, tw, out_digits)
                e = max_abs_err(kernels.dft_level(*args), want)
                km = cuda_ms(lambda: kernels.dft_level(*args))
                dm = device_ms(lambda: kernels.dft_level(*args))
                print(f"dft_level p{field.modulus.bit_length()} (L = {L}) m={m} cols={cols} "
                      f"rest={rest} {mode} {kind} in, {'digits' if out_digits else 'limbs'} out: "
                      f"max_abs_err={e} kernel {km:.4f} ms (device {fmt_ms(dm)}) "
                      f"plain {pm:.4f} ms", flush=True)
                require(e == 0, "dft_level kernel != plain version")
                err = max(err, e)
                # the main path's transform: limbs in at level 0, digits out
                # except at the last level
                on_path = out_digits == (lvl < len(plan.levels) - 1) and (
                    kind == ("limbs view" if lvl == 0 else "digits"))
                if main and on_path:
                    k_ms += km
                    p_ms += pm
                    d_ms = None if d_ms is None or dm is None else d_ms + dm
                    cost = dft_level_cost(L, m, cols, tw, kind != "digits", out_digits, folds)
                    n_bytes += cost["bytes"]
                    work += cost["work"]
        if main:
            a = plan.w8s[lvl].reshape(D * m, m)
            b = x8.permute(1, 0, 2).reshape(m, D * cols).contiguous()
            try:
                mm = cuda_ms(lambda: torch._int_mm(a, b))
                mm_ms += mm
                print(f"  torch._int_mm [{D * m}, {m}] x [{m}, {D * cols}] (the level's digit "
                      f"products, no diagonals, no epilogue): {mm:.4f} ms", flush=True)
            except Exception as exc:  # noqa: BLE001 - a yardstick only
                mm_ms = None
                print(f"  torch._int_mm not measured: {exc!r}", flush=True)
    results["dft_level"]["max_abs_err"] = max(results["dft_level"]["max_abs_err"], err)
    if main:
        results["dft_level"].update(ms=k_ms, plain_ms=p_ms, device_ms=d_ms, bytes=n_bytes,
                                    work=work)
        print(f"dft_level: the three levels of a p128 2^17 transform as the main path runs "
              f"them: {k_ms:.4f} ms (events), device {fmt_ms(d_ms)}; torch._int_mm on the same "
              f"digit products {fmt_ms(mm_ms)}", flush=True)


def large_ms(fn):
    """(events ms, device ms) of a call of fn() that runs for a millisecond
    or so: CUDA events (mean of 5 after a warm-up), where the wrapper's
    host cost is small beside the kernel, and the port kernels' device time
    from torch.profiler (`device_ms`, taken twice if the profiler records
    no port kernel the first time; None if it records none either time)."""
    em = cuda_ms(fn)
    dm = device_ms(fn, reps=5)
    return em, dm if dm is not None else device_ms(fn, reps=5)


def dft_level_cost(L: int, m: int, cols: int, tw, in_limbs: bool, out_digits: bool,
                   folds: int) -> dict:
    """Bytes and work of one kernel-1 level: its input read (int32 limbs or
    int8 digit planes), the digit matrix and the twiddle tables read, its
    output written (digit planes or limbs); m*D^2 int8 digit multiply-adds
    per output (2 ops each, at the card's int8 tensor-core rate), the
    solinas folds that reduce the wide integer, and 1 (direct panel) or 2
    (factored) twiddle products on the word product."""
    D = 2 * L + 1
    products = 0 if tw is None else (1 if "p" in tw else 2)
    tw_bytes = sum(t.numel() * 4 for t in (tw or {}).values())
    return {"bytes": ((4 * L if in_limbs else D) * m * cols + D * m * m + tw_bytes
                      + (D if out_digits else 4 * L) * m * cols),
            "work": [("int8_mma", 2 * m * cols * m * D * D), ("u32", m * cols * folds),
                     (("mont", L), m * cols * products)]}


def check_dft_chain(device, field, plan, label: str, results, rates=None):
    """Kernel 1 at every level of one transform plan, each level fed as
    `ntt._digit_transform` feeds it: level 0 int32 limbs [L, n] as the view
    [L, 1, m, r] (its digits carry the plan's scale), every later level the
    previous level's int8 digit planes as the view [D, pre, m, r] (the
    kernel's output, once it has equalled the plain version's); each level's
    twiddle (none, direct, or factored at its rest); digits out but at the
    last level; 0, 1 and p - 1 among the transform's inputs.  Each level
    against `plain_level`, tolerance 0.  With `rates`, each level's time
    beside its bound (`large_ms`); returns (events ms, device ms, bound ms)
    summed over the levels, or None without rates."""
    import torch
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.field.limbs import ints_to_limbs
    dev = field.device_field(device)
    L, n, q = dev.L, plan.n, len(plan.levels)
    folds = solinas_fold_mults(field.modulus)
    cur = device_elements(device, 50 + n.bit_length(), field.modulus, L, n)
    cur[:, :3] = torch.as_tensor(ints_to_limbs([0, 1, field.modulus - 1], L).astype("int32"),
                                 device=device)
    pre, rest, total = 1, n, [0.0, 0.0, 0.0]
    for lvl, m in enumerate(plan.levels):
        rest //= m
        view = cur.reshape(cur.shape[0], pre, m, rest)
        tw = plan.tws[lvl] if rest > 1 else None
        args = (dev, plan.w8s[lvl], view, m, rest, tw, lvl < q - 1)
        got = kernels.dft_level(*args)
        e = max_abs_err(got, plain_level(*args))
        mode = "none" if tw is None else ("direct" if "p" in tw else
                                          f"factored s = {tw['b'].shape[-1]}")
        timing = ""
        if rates is not None:
            em, dm = large_ms(lambda: kernels.dft_level(*args))
            cost = dft_level_cost(L, m, n // m, tw, lvl == 0, lvl < q - 1, folds)
            bound_ms, bound_by, _ = bound(cost, rates)
            total[0] += em
            total[1] = None if total[1] is None or dm is None else total[1] + dm
            total[2] += bound_ms
            timing = (f"; events {em:.4f} ms, device {fmt_ms(dm)}, against a bound of "
                      f"{bound_ms:.4f} ms ({bound_by})")
        print(f"dft_level {label} level {lvl} (m = {m}, pre = {pre}, rest = {rest}, {mode}, "
              f"{'limbs' if lvl == 0 else 'digits'} in, "
              f"{'digits' if lvl < q - 1 else 'limbs'} out): max_abs_err={e}{timing}",
              flush=True)
        require(e == 0, f"dft_level != plain version at {label} level {lvl}")
        results["dft_level"]["max_abs_err"] = max(results["dft_level"]["max_abs_err"], e)
        cur = got.reshape(got.shape[0], m * pre, rest)
        pre *= m
    return None if rates is None else tuple(total)


def solinas_fold_mults(modulus: int) -> int:
    """32-bit multiplies per output of the static solinas folds that bring
    kernel 1's wide integer (its lazy limbs and two carry limbs) below
    2^(16L + 1), for p = 2^(16L) - u * 2^(16a) + 1: each fold multiplies
    the part above 2^(16L) by u, a lo and a hi multiply per 32-bit word of
    that part (p128: three folds, 24 multiplies)."""
    from genstark_tpu_torch.ntt import dft
    L, _, nd, u, a = dft.solinas_spec(modulus)
    bits, mults = 16 * (dft._n_lazy(nd) + 2), 0
    while bits > 16 * L + 1:
        high = bits - 16 * L
        mults += 2 * -(-high // 32)
        bits = max(16 * L, high + u.bit_length() + 16 * a) + 1
    return mults


def check_hash_words(dev, rng, results):
    """Kernel 2 at the slice's shape (the first e-tree pair level, 2^16
    pairs of 64 bytes), both algorithms, plus hashlib."""
    import numpy as np
    import torch
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.hash import digest_rows_ref, create_hash, digests_to_bytes
    Ne = 2 ** 17
    for algo in ("blake2s256", "sha256"):
        h = create_hash(algo)
        words = torch.as_tensor(rng.integers(-2**31, 2**31, size=(16, Ne // 2), dtype=np.int64)
                                .astype(np.int32), device=dev.device)
        got = kernels.hash_words(algo, words, 64)
        want = digest_rows_ref(algo, words, 64)
        e = max_abs_err(got, want)
        msg = np.ascontiguousarray(words[:, :4].cpu().numpy().T).view("<u4")
        ref = [h.digest(msg[i].tobytes()) for i in range(4)]
        require(digests_to_bytes(got[:, :4].cpu().numpy().view(np.uint32)) == ref,
                f"{algo} hash_words != hashlib")
        km = cuda_ms(lambda: kernels.hash_words(algo, words, 64))
        pm = cuda_ms(lambda: digest_rows_ref(algo, words, 64), reps=2)
        print(f"hash_words {algo} B={Ne // 2} 64-byte: max_abs_err={e} "
              f"kernel {km:.4f} ms plain {pm:.4f} ms", flush=True)
        require(e == 0, "hash_words kernel != plain version")
        r = results["hash_words"]
        r["max_abs_err"] = max(r["max_abs_err"], e)
        if algo == "blake2s256":
            r.update(ms=km, plain_ms=pm, bytes=(64 + 32) * (Ne // 2),
                     device_ms=device_ms(lambda: kernels.hash_words(algo, words, 64)),
                     work=[("u32", (Ne // 2) * BLAKE2S_BLOCK_OPS)])


def check_hash_limbs(dev, field, rng, results, record_times: bool = True):
    """Kernel 3 at the slice's shapes, both algorithms, plus hashlib: the
    e-tree leaves (V = 2 vectors of 2^17 elements) and the stride-4 FRI rows
    (4 elements: 64 bytes at p128, 128 bytes, two blake2s blocks, at p256)."""
    import numpy as np
    import torch
    from genstark_tpu_torch.hash import create_hash, digest_rows_ref, digests_to_bytes, elements_to_words
    Ne, L, elem = 2 ** 17, dev.L, field.element_size
    M = Ne // 4
    vecs = dev.from_numpy(np.stack([random_elements(rng, field.modulus, L, Ne)
                                    for _ in range(2)]))
    layer = vecs[0]
    raw = np.ascontiguousarray(vecs.cpu().numpy().astype("<u2"))
    leaf_msgs = [raw[0, :, i].tobytes() + raw[1, :, i].tobytes() for i in range(3)]
    row_msgs = [b"".join(raw[0, :, k * M + i].tobytes() for k in range(4)) for i in range(3)]
    for algo in ("blake2s256", "sha256"):
        h = create_hash(algo)
        leaves_ref = lambda: digest_rows_ref(algo, torch.cat(
            [elements_to_words(vecs[v]) for v in range(2)]), 2 * elem)
        got = h.merge_element_rows(vecs, elem)
        e1 = max_abs_err(got, leaves_ref())
        require(digests_to_bytes(got[:, :3].cpu().numpy().view(np.uint32))
                == [h.digest(x) for x in leaf_msgs], f"{algo} hash_limbs leaves != hashlib")
        km = cuda_ms(lambda: h.merge_element_rows(vecs, elem))
        pm = cuda_ms(leaves_ref, reps=2)
        got = h.digest_stride_rows(layer, elem)
        e2 = max_abs_err(got, digest_rows_ref(algo, torch.cat(
            [elements_to_words(layer[:, k * M:(k + 1) * M]) for k in range(4)]), 4 * elem))
        require(digests_to_bytes(got[:, :3].cpu().numpy().view(np.uint32))
                == [h.digest(x) for x in row_msgs], f"{algo} hash_limbs rows != hashlib")
        km2 = cuda_ms(lambda: h.digest_stride_rows(layer, elem))
        print(f"hash_limbs {algo} L={L}: leaves V=2 B={Ne} max_abs_err={e1} kernel "
              f"{km:.4f} ms plain {pm:.4f} ms; {4 * elem}-byte stride4 rows M={M} "
              f"max_abs_err={e2} kernel {km2:.4f} ms", flush=True)
        require(e1 == 0 and e2 == 0, "hash_limbs kernel != plain version")
        r = results["hash_limbs"]
        r["max_abs_err"] = max(r["max_abs_err"], e1, e2)
        if algo == "blake2s256" and record_times:
            # leaves: 2 vectors of L int32 limbs read, one digest written
            r.update(ms=km, plain_ms=pm, bytes=(2 * L * 4 + 32) * Ne,
                     device_ms=device_ms(lambda: h.merge_element_rows(vecs, elem)),
                     work=[("u32", Ne * BLAKE2S_BLOCK_OPS * -(-2 * elem // 64))])


# Kernel 3's forms (leaves of 1, 2 and 4 vectors in the compile-time form,
# 3 in the runtime form, stride-4 rows) run at these batches (messages) at
# every L; 2^22 messages at L = 16.
HASH_FORMS = (1, 2, 3, 4, "rows")
HASH_BATCHES = (1, 255, 2 ** 17)


def limbs_values(device, seed: int, field, form, batch: int):
    """Kernel 3's input for `batch` messages of one form, made on the card:
    leaves [V, L, batch], or rows [L, 4 * batch]."""
    L, p = field.params.L, field.modulus
    if form == "rows":
        return device_elements(device, seed, p, L, 4 * batch)
    return device_elements(device, seed, p, L, form, batch).transpose(0, 1).contiguous()


def limbs_plain(algo: str, values, form, elem: int, i0: int, i1: int):
    """The plain version of kernel 3 over messages [i0, i1) of `values`."""
    import torch
    from genstark_tpu_torch.hash import digest_rows_ref, elements_to_words
    if form == "rows":
        M = values.shape[1] // 4
        parts = [values[:, k * M + i0:k * M + i1] for k in range(4)]
    else:
        parts = [values[v][:, i0:i1] for v in range(form)]
    return digest_rows_ref(algo, torch.cat([elements_to_words(t) for t in parts]),
                           len(parts) * elem)


def limbs_cost(V: int, L: int, batch: int) -> dict:
    """Bytes and work of one blake2s kernel-3 call: V elements of L int32
    limbs read and a 32-byte digest written a message; 1,120 u32 ops a
    64-byte block."""
    return {"bytes": (V * L * 4 + 32) * batch,
            "work": [("u32", batch * BLAKE2S_BLOCK_OPS * -(-(2 * V * L) // 64))]}


def check_hash_limbs_forms(device, fields, results):
    """Kernel 3 against its plain version, one launch each: both algorithms,
    every L, every form of HASH_FORMS at HASH_BATCHES, and at 2^22 messages
    P256 leaves of two vectors (the 2^18-step path's leaves) and stride-4
    rows.  The plain version runs in column chunks."""
    from genstark_tpu_torch import kernels
    seeds = iter(range(200, 10 ** 6))
    cases = [(f, form, B) for f in fields for form in HASH_FORMS for B in HASH_BATCHES]
    cases += [(fields[-1], form, 2 ** 22) for form in (2, "rows")]
    for algo in ("blake2s256", "sha256"):
        errs = {}
        for field, form, B in cases:
            values = limbs_values(device, next(seeds), field, form, B)
            before = kernels.launch_counts["hash_limbs"]
            got = kernels.hash_limbs(algo, values, rows=form == "rows")
            require(kernels.launch_counts["hash_limbs"] == before + 1, "hash_limbs launches")
            e = chunked_err(got, lambda i0, i1: limbs_plain(
                algo, values, form, field.element_size, i0, i1), B, 1 << 20)
            require(e == 0, f"hash_limbs kernel != plain version: {algo} L = {field.params.L} "
                            f"form {form} batch {B}")
            key = (field.params.L, B)
            errs[key] = max(errs.get(key, 0), e)
            results["hash_limbs"]["max_abs_err"] = max(results["hash_limbs"]["max_abs_err"], e)
            del values, got
        print(f"hash_limbs {algo}: forms {HASH_FORMS} max_abs_err by (L, batch) {errs}",
              flush=True)


# The Merkle configurations' commitments: (label, modulus, V = trace
# registers + secret inputs, Ne, ext, B asserted registers).
MERKLE_SHAPES = (("rescue16", "P128", 10, 2 ** 13, 16, 1),
                 ("poseidon16", "P128", 16, 2 ** 15, 32, 2),
                 ("lib224", "P224", 8, 2 ** 14, 32, 1))


def check_merkle_shapes(device, rng, results):
    """Kernel 3's runtime form (leaves of V vectors outside 1, 2 and 4) and
    kernel 4 (its constants in shared memory) at the Merkle configurations'
    shapes, against their plain versions."""
    from genstark_tpu_torch import field as fields
    from genstark_tpu_torch import kernels
    seeds = iter(range(300, 400))
    for label, name, V, Ne, ext, B in MERKLE_SHAPES:
        field = fields.create_prime_field(getattr(fields, name))
        values = limbs_values(device, next(seeds), field, V, Ne)
        for algo in ("blake2s256", "sha256"):
            e = max_abs_err(kernels.hash_limbs(algo, values, rows=False),
                            limbs_plain(algo, values, V, field.element_size, 0, Ne))
            print(f"hash_limbs {algo} {label}: leaves V={V} L={field.params.L} B={Ne} "
                  f"max_abs_err={e}", flush=True)
            require(e == 0, f"hash_limbs kernel != plain version at {label}'s leaves")
            r = results["hash_limbs"]
            r["max_abs_err"] = max(r["max_abs_err"], e)
        check_tail(field.device_field(device), field, rng, results, record_times=False,
                   shape=(Ne, ext, B, V))


def check_tail(dev, field, rng, results, record_times: bool = True,
               shape=(2 ** 17, 16, 1, 2)):
    """Kernel 4 at the bench shape (Ne, ext, B, V) = (2^17, 16, 1, 2), or
    another `shape`: raised copies on, factored tables with s = 256, at the
    field's L.  Run at every L, it holds each instantiation of the word
    product's carry chains (field.cuh) bit for bit, as the compiler emitted
    them."""
    import numpy as np
    from genstark_tpu_torch.field.limbs import power_series_mont_np
    from genstark_tpu_torch.protocol.lincomb_kernel import lcomb_tail, lcomb_tail_ref
    (Ne, ext, B, V), s = shape, 256
    p, L = field.modulus, dev.L
    rnd = lambda n: dev.from_numpy(random_elements(rng, p, L, n))
    qe = rnd(Ne)
    b_stack = dev.from_numpy(np.stack([random_elements(rng, p, L, Ne) for _ in range(B)]))
    e_std = dev.from_numpy(np.stack([random_elements(rng, p, L, Ne) for _ in range(V)]))
    g = field.get_root_of_unity(Ne)
    dom = (dev.from_numpy(power_series_mont_np(field.params, pow(g, s, p), Ne // s)),
           dev.from_numpy(power_series_mont_np(field.params, g, s)))
    h = pow(g, 3, p)
    incr = (dev.from_numpy(power_series_mont_np(field.params, pow(h, s, p), Ne // s)),
            dev.from_numpy(power_series_mont_np(field.params, h, s)))
    inv_series, b_coeffs, l_coeffs = rnd(ext), rnd(2 * B), rnd(2 * V)
    x_last = int(rng.integers(1, 1 << 62))
    args = (dev, qe, b_stack, e_std, dom, incr, inv_series, x_last, b_coeffs,
            l_coeffs, True, True, ext)
    e = max_abs_err(lcomb_tail(*args), lcomb_tail_ref(*args))
    km = cuda_ms(lambda: lcomb_tail(*args))
    dm = device_ms(lambda: lcomb_tail(*args))
    pm = cuda_ms(lambda: lcomb_tail_ref(*args), reps=2)
    print(f"lcomb_tail Ne={Ne} L={L} ext={ext} B={B} V={V}: max_abs_err={e} "
          f"kernel {km:.4f} ms (device {fmt_ms(dm)}) plain {pm:.4f} ms", flush=True)
    require(e == 0, "lcomb_tail kernel != plain version")
    r = results["lcomb_tail"]
    r["max_abs_err"] = max(r["max_abs_err"], e)
    if record_times:
        r.update(ms=km, plain_ms=pm, device_ms=dm, **tail_cost(args))


def tail_cost(args) -> dict:
    """Bytes and work of one kernel-4 call: qe, b, e read and the output
    written at L int32 limbs per position, the small tables once; 4 + 3B +
    3V word products per position with both raised copies (dom, zinv, qe,
    incr, and 3 per b and per e)."""
    _, qe, b_stack, e_std, dom, incr, inv_series, _, b_coeffs, l_coeffs = args[:10]
    L, Ne = qe.shape
    B, V = b_stack.shape[0], e_std.shape[0]
    tables = sum(t.numel() for t in (*dom, *incr, inv_series, b_coeffs, l_coeffs)) * 4
    return {"bytes": (2 + B + V) * L * 4 * Ne + tables,
            "work": [(("mont", L), (4 + 3 * B + 3 * V) * Ne)]}


def p_minus_1(field, n: int):
    from genstark_tpu_torch.field.limbs import ints_to_limbs
    return ints_to_limbs([field.modulus - 1] * n, field.params.L)


def check_field_ew(device, fields, rng, results):
    """Kernel 5 at every L: mul, add and sub with same-shape operands (every
    ordered pair of edge_values among them), a scalar on either side (a
    random one, and each of 0, 1 and p - 1) and p - 1 everywhere, at [L,
    2^15]; at the path's [16, 2^17] for P256, whose mul is the kernel's
    reported time, taken over DRAM_SETS operand sets in turn (from device
    memory; the time of one set, from L2, is printed beside it)."""
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.testing import edge_pairs, plant
    r = results["field_ew"]
    for field in fields:
        dev = field.device_field(device)
        sizes = (2 ** 15, 2 ** 17) if dev.L == 16 else (2 ** 15,)
        xs, ys = edge_pairs(field)
        p = field.modulus
        scalars = [dev.from_numpy(random_elements(rng, p, dev.L, 1))] + [
            dev.from_numpy(plant(field, random_elements(rng, p, dev.L, 1), [v], 0))
            for v in (0, 1, p - 1)]
        for n in sizes:
            a = dev.from_numpy(plant(field, random_elements(rng, p, dev.L, n), xs, 0))
            b = dev.from_numpy(plant(field, random_elements(rng, p, dev.L, n), ys, 0))
            pm1 = dev.from_numpy(p_minus_1(field, n))
            pairs = [(a, b), (pm1, pm1)] + [pair for c in scalars for pair in ((a, c), (c, a))]
            reported = dev.L == 16 and n == 2 ** 17
            sets = [(a, b)] + [tuple(dev.from_numpy(random_elements(rng, p, dev.L, n))
                                     for _ in range(2)) for _ in range(DRAM_SETS - 1)] \
                if reported else [(a, b)]
            for op, ref in (("mul", dev.mont_mul_ref), ("add", dev.add_ref),
                            ("sub", dev.sub_ref)):
                err = 0
                for x, y in pairs:
                    err = max(err, max_abs_err(kernels.field_ew(dev, op, x, y), ref(x, y)))
                call = in_turn(lambda x, y: kernels.field_ew(dev, op, x, y), sets)
                km = cuda_ms(call)
                pm = cuda_ms(lambda: ref(a, b), reps=2)
                timing = f"kernel {km:.4f} ms"
                if reported:
                    dm = device_ms(call)
                    l2 = device_ms(lambda: kernels.field_ew(dev, op, a, b))
                    timing += (f" over {len(sets)} operand sets in turn (device {fmt_ms(dm)}; "
                               f"one set, from L2: device {fmt_ms(l2)})")
                print(f"field_ew p{p.bit_length()} L={dev.L} {op} [L, {n}] (same shape with "
                      f"the edge pairs, scalar right and left: random, 0, 1, p-1; p-1): "
                      f"max_abs_err={err} {timing} plain {pm:.4f} ms", flush=True)
                require(err == 0, "field_ew kernel != plain version")
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if reported and op == "mul":
                    r.update(ms=km, plain_ms=pm, bytes=3 * dev.L * 4 * n, device_ms=dm,
                             work=[(("mont", dev.L), n)])
            del sets


# Kernel 6's shapes: the path's factored tables (nj = 512, s = 256), a
# 2^22-product table (the 2^18-step path's Ne-point factors) and an s that
# is not a power of two.
OUTER_SHAPES = ((512, 256), (2048, 2048), (37, 300))


def check_outer(device, fields, rng, results):
    """Kernel 6 at every L and OUTER_SHAPES against its plain version, one
    launch each; the reported time is nj = 512, s = 256 at L = 16."""
    from genstark_tpu_torch import kernels
    r = results["outer_table"]
    for field in fields:
        dev = field.device_field(device)
        for nj, s in OUTER_SHAPES:
            outer = dev.from_numpy(random_elements(rng, field.modulus, dev.L, nj))
            inner = dev.from_numpy(random_elements(rng, field.modulus, dev.L, s))
            before = kernels.launch_counts["outer_table"]
            got = dev.outer_table(outer, inner)
            require(kernels.launch_counts["outer_table"] == before + 1, "outer_table launches")
            e = max_abs_err(got, dev.outer_table_ref(outer, inner))
            del got
            timing = ""
            if dev.L == 16 and (nj, s) == OUTER_SHAPES[0]:
                km = cuda_ms(lambda: kernels.outer_table(dev, outer, inner))
                pm = cuda_ms(lambda: dev.outer_table_ref(outer, inner), reps=2)
                r.update(ms=km, plain_ms=pm, **outer_cost(dev.L, nj, s),
                         device_ms=device_ms(lambda: kernels.outer_table(dev, outer, inner)))
                timing = f" kernel {km:.4f} ms (device {fmt_ms(r['device_ms'])}) plain {pm:.4f} ms"
            print(f"outer_table p{field.modulus.bit_length()} L={dev.L} nj={nj} s={s}: "
                  f"max_abs_err={e}{timing}", flush=True)
            require(e == 0, f"outer_table kernel != plain version at L = {dev.L}, {nj} x {s}")
            r["max_abs_err"] = max(r["max_abs_err"], e)


def outer_cost(L: int, nj: int, s: int) -> dict:
    """Bytes and work of one kernel-6 call: the factors read and the table
    written once; nj * s word products."""
    return {"bytes": (nj + s + nj * s) * L * 4, "work": [(("mont", L), nj * s)]}


def check_butterfly(device, fields, rng, results):
    """Kernel 8 at every L: a direct 2048-point local transform, and both
    passes of the four-step split of the path's 2^13-, 2^15- and 2^17-point
    transforms, in the strided layouts the transform gives them, every
    ordered pair of edge_values at each pass's first butterflies
    (edge_input: natural j and j + n/2 for the first pass and the direct
    transform, j and j + n2/2 of row 0 for the second); then one whole
    2^17-point transform (kernels 8 and 5) against the plain path.  The
    reported time is the two passes of the P256 2^17-point transform."""
    import torch
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.ntt import radix2
    from genstark_tpu_torch.testing import edge_input
    r = results["butterfly"]
    for field in fields:
        dev = field.device_field(device)
        L = dev.L
        for n in (2048, 2 ** 13, 2 ** 15, 2 ** 17):
            plan = radix2.Radix2Plan(field, dev, n, field.get_root_of_unity(n),
                                     field.inv(field.params.R_mod % field.modulus))
            halves = (n // 2,) + (() if plan.split is None else (plan.split[1] // 2,))
            x = dev.from_numpy(edge_input(field, random_elements(rng, field.modulus, L, n),
                                          halves))
            if plan.split is None:
                x = x.reshape(1, 1, L, n)
                calls = [(x, plan.tables[0], None)]
            else:
                n1, n2 = plan.split
                y = torch.empty((L, 1, n1, n2), dtype=torch.int32, device=device)
                out = torch.empty((1, L, n2, n1), dtype=torch.int32, device=device)
                calls = [(x.reshape(1, L, n1, n2).permute(0, 3, 1, 2), plan.tables[0],
                          y.permute(1, 3, 0, 2)),
                         (x.reshape(L, 1, n1, n2).permute(1, 2, 0, 3), plan.tables[1],
                          out.permute(0, 3, 1, 2))]
            err, km, pm, dm = 0, 0.0, 0.0, 0.0
            for xin, tab, o in calls:
                got = kernels.butterfly(dev, xin, tab, o)
                want = radix2.butterfly_ref(dev, xin, tab)
                err = max(err, max_abs_err(got, want))
                km += cuda_ms(lambda: kernels.butterfly(dev, xin, tab, o))
                pm += cuda_ms(lambda: radix2.butterfly_ref(dev, xin, tab), reps=2)
                if L == 16 and n == 2 ** 17:
                    one = device_ms(lambda: kernels.butterfly(dev, xin, tab, o))
                    dm = None if dm is None or one is None else dm + one
            print(f"butterfly p{field.modulus.bit_length()} L={L} n={n} local "
                  f"{plan.split or (n,)}: max_abs_err={err} kernel {km:.4f} ms "
                  f"plain {pm:.4f} ms", flush=True)
            require(err == 0, "butterfly kernel != plain version")
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if L == 16 and n == 2 ** 17:
                # two passes, each reading and writing the array once; one
                # Montgomery product per butterfly, (n/2) log2 n in all
                r.update(ms=km, plain_ms=pm, device_ms=dm, bytes=2 * 2 * L * 4 * n,
                         work=[(("mont", L), (n // 2) * (n.bit_length() - 1))])
            if n == 2 ** 17:
                xb = dev.from_numpy(random_elements(rng, field.modulus, L, 2 * n))
                xb = xb.reshape(L, 2, n).permute(1, 0, 2)
                e = max_abs_err(radix2.transform(dev, xb, plan),
                                radix2.transform_ref(dev, xb, plan))
                print(f"radix-2 transform p{field.modulus.bit_length()} n={n} B=2 (R^-1 "
                      f"folded), kernel path vs plain path: max_abs_err={e}", flush=True)
                require(e == 0, "radix-2 transform (kernels 8, 5) != plain path")


def check_demo_field(device, rng, results):
    """Kernels 5 and 8 at the demo-static field p = DEMO_MODULUS (L = 2: one
    word, p far below R = 2^32), whose pin the demo-static path also
    proves: mul, add and sub over every ordered pair of edge_values, with
    0, 1 and p - 1 as a scalar on either side; the local transforms of 64
    and 512 points (512: the field's largest power-of-two root), B = 2
    rows of G = 3, both entries, with the edge pairs planted."""
    import numpy as np
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.field import create_prime_field
    from genstark_tpu_torch.field.limbs import power_series_mont_np
    from genstark_tpu_torch.ntt import radix2
    from genstark_tpu_torch.testing import edge_input, edge_pairs, plant
    field = create_prime_field(DEMO_MODULUS)
    dev = field.device_field(device)
    p, L = field.modulus, dev.L
    xs, ys = edge_pairs(field)
    a = dev.from_numpy(plant(field, random_elements(rng, p, L, 4096), xs, 0))
    b = dev.from_numpy(plant(field, random_elements(rng, p, L, 4096), ys, 0))
    scalars = [dev.from_numpy(plant(field, random_elements(rng, p, L, 1), [v], 0))
               for v in (0, 1, p - 1)]
    pairs = [(a, b)] + [pair for c in scalars for pair in ((a, c), (c, a))]
    err = 0
    for op, ref in (("mul", dev.mont_mul_ref), ("add", dev.add_ref), ("sub", dev.sub_ref)):
        for x, y in pairs:
            err = max(err, max_abs_err(kernels.field_ew(dev, op, x, y), ref(x, y)))
    print(f"field_ew p={p} L={L} mul/add/sub over the edge pairs and 0, 1, p-1 scalars: "
          f"max_abs_err={err}", flush=True)
    require(err == 0, f"field_ew kernel != plain version at p = {p}")
    results["field_ew"]["max_abs_err"] = max(results["field_ew"]["max_abs_err"], err)
    err = 0
    for n in (64, 512):
        table = dev.from_numpy(power_series_mont_np(field.params, field.get_root_of_unity(n),
                                                    n // 2))
        # six rows, each with the next n/2 of the edge pairs
        rows = [edge_input(field, random_elements(rng, p, L, n), shift=r * n // 2 % len(xs))
                for r in range(6)]
        x = dev.from_numpy(np.stack(rows)).reshape(2, 3, L, n)
        for bitrev_in in (False, True):
            err = max(err, max_abs_err(kernels.butterfly(dev, x, table, bitrev_in=bitrev_in),
                                       radix2.butterfly_ref(dev, x, table, bitrev_in=bitrev_in)))
    print(f"butterfly p={p} L={L} n=64, 512, both entries, edge pairs: max_abs_err={err}",
          flush=True)
    require(err == 0, f"butterfly kernel != plain version at p = {p}")
    results["butterfly"]["max_abs_err"] = max(results["butterfly"]["max_abs_err"], err)


def check_stages(device, fields, rng, results):
    """Kernels 7 and 9 bit for bit against butterfly_stages_ref, every
    ordered pair of edge_values added and subtracted at each pass's first
    butterflies (edge_input with the table's root: the hi planted divided by
    its twiddle): at the main path's shape (P256, n = LARGE_N, one row)
    each pass the direct route runs there (radix2.stage_passes), and
    one-stage passes at every m = 2048 .. n/2; at every other L at n = 2^15
    the route's pass from m = 2048 (k = 4), a two-stage pass from m = 8192,
    and one-stage passes at m = 2048 and 8192.  The reported times are the
    route's passes at LARGE_N, one launch each; the one-stage passes there
    are timed too (the time of each stage alone)."""
    import torch
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.ntt import radix2
    from genstark_tpu_torch.testing import edge_input
    for field in fields:
        dev = field.device_field(device)
        L = dev.L
        n = LARGE_N if L == 16 else 2 ** 15
        table = stage_tables(field, dev, n)[0]
        passes = radix2.stage_passes(n, radix2.LOCAL_MAX, radix2.PASS_DEPTH)
        lm0 = radix2.LOCAL_MAX.bit_length() - 1
        ones = range(lm0, n.bit_length() - 1) if L == 16 else (lm0, lm0 + 2)
        extra = [] if L == 16 else [(1 << (lm0 + 2), 2)]
        runs = passes + extra + [(1 << lm, 1) for lm in ones]
        x = dev.from_numpy(edge_input(field, random_elements(rng, field.modulus, L, n),
                                      sorted({m for m, _ in runs}),
                                      root=field.get_root_of_unity(n)))
        x = x.reshape(1, L, n)
        total, single = 0.0, 0.0
        for i, (m, k) in enumerate(runs):
            row = "bfly_stage" if m <= kernels.STAGE_SPLIT_ABOVE else "bfly_stage_split"
            got = kernels.butterfly_stages(dev, x.clone(), table, m, k)
            e = max_abs_err(got, radix2.butterfly_stages_ref(dev, x.clone(), table, m, k))
            del got
            require(e == 0, f"{row} kernel != plain version at L = {L}, n = {n}, m = {m}, k = {k}")
            results[row]["max_abs_err"] = max(results[row]["max_abs_err"], e)
            timing = ""
            if L == 16:
                work = x.clone()
                km = cuda_ms(lambda: kernels.butterfly_stages(dev, work, table, m, k))
                timing = f" kernel {km:.4f} ms"
                if i < len(passes):
                    pm = cuda_ms(lambda: radix2.butterfly_stages_ref(dev, work, table, m, k),
                                 reps=1)
                    total += km
                    timing += f" plain {pm:.4f} ms"
                    # the array read and written once; the twiddles of the
                    # k stages read once: those of stage m_j are every
                    # 2^(k-1-j)-th of the last stage's m << (k-1); k * n/2
                    # Montgomery products
                    results[row].update(ms=km, plain_ms=pm, device_ms=device_ms(
                        lambda: kernels.butterfly_stages(dev, work, table, m, k), reps=5),
                                        bytes=2 * L * 4 * n + L * 4 * (m << (k - 1)),
                                        work=[(("mont", L), k * n // 2)])
                else:
                    single += km
                del work
            print(f"{row} p{field.modulus.bit_length()} L={L} n={n} pass m={m} k={k}: "
                  f"max_abs_err={e}{timing}", flush=True)
        if L == 16:
            print(f"stage passes of one {n}-point transform {passes}: {total:.4f} ms in "
                  f"{len(passes)} launches; one stage a launch: {single:.4f} ms in "
                  f"{len(ones)} launches", flush=True)
        del x, table
        torch.cuda.empty_cache()


def stage_tables(field, dev, n: int):
    """(stage table [n/2, L] element-major, local half-table [L,
    LOCAL_MAX/2]) of the n-th root: the direct plan's own tables where n
    takes the direct route, else host-built."""
    from genstark_tpu_torch.field.limbs import power_series_mont_np
    from genstark_tpu_torch.ntt import radix2
    root = field.get_root_of_unity(n)
    if radix2.route_for(n) == "direct":
        plan = radix2.Radix2Plan(field, dev, n, root)
        return plan.twiddles, plan.tables[0]
    local = radix2.LOCAL_MAX
    return (dev.from_numpy(power_series_mont_np(field.params, root, n // 2).T.copy()),
            dev.from_numpy(power_series_mont_np(field.params, pow(root, n // local, field.modulus),
                                                local // 2)))


def check_butterfly_bitrev(device, fields, rng, results):
    """Kernel 8's bit-reversed entry (the direct route's local pass) against
    its plain version: the 2048-point blocks of a bit-reversed array, at
    every L (n = 2^15) and at the main path's P256 n = LARGE_N, in place
    (timed there), every ordered pair of edge_values at the first stage's
    butterflies (neighbours, against the twiddle 1)."""
    import torch
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.ntt import radix2
    from genstark_tpu_torch.testing import edge_pairs, plant
    for field in fields:
        dev = field.device_field(device)
        L = dev.L
        n = LARGE_N if L == 16 else 2 ** 15
        local = radix2.LOCAL_MAX
        table = stage_tables(field, dev, n)[1]
        # in bit-reversed input the first stage pairs neighbours: xs and ys
        # interleaved, every ordered edge pair at two positions of one block
        xs, ys = edge_pairs(field)
        x = plant(field, random_elements(rng, field.modulus, L, n),
                  [v for pair in zip(xs, ys) for v in pair], 0)
        x = dev.from_numpy(x).reshape(1, L, n)
        blocks = lambda t: t.view(1, L, n // local, local).permute(0, 2, 1, 3)
        want = radix2.butterfly_ref(dev, blocks(x), table, bitrev_in=True)
        got = x.clone()
        kernels.butterfly(dev, blocks(got), table, out=blocks(got), bitrev_in=True)
        e = max_abs_err(blocks(got), want)
        timing = ""
        if L == 16:
            km = cuda_ms(lambda: kernels.butterfly(dev, blocks(got), table, out=blocks(got),
                                                   bitrev_in=True))
            timing = f" kernel {km:.4f} ms"
        print(f"butterfly (bit-reversed input, in place) p{field.modulus.bit_length()} L={L} "
              f"n={n} blocks of {local}: max_abs_err={e}{timing}", flush=True)
        require(e == 0, "butterfly bit-reversed entry != plain version")
        results["butterfly"]["max_abs_err"] = max(results["butterfly"]["max_abs_err"], e)
        del x, want, got, table
        torch.cuda.empty_cache()


def check_inv(kernels, device, fields, rng) -> None:
    """DeviceField.inv on the card against inv_ref, zeros included: 4099
    elements (not a power of two) with zeros first, inside and last, and a
    batched [L, 3, 16], at every L; every product one kernel-5 launch, 2
    ceil(log2 N) + 2 of them.  Then [16, 2^20] over P256 (the 2^18-step
    path's composition domain), timed."""
    import numpy as np
    for field in fields:
        dev = field.device_field(device)
        L = dev.L
        shapes = ((4099,), (3, 16)) + (((2 ** 20,),) if L == 16 else ())
        for shape in shapes:
            n = int(np.prod(shape))
            a = random_elements(rng, field.modulus, L, n)
            a[:, [0, 7, n // 2, n - 1]] = 0
            x = dev.from_numpy(a).reshape((L,) + shape)
            before = kernels.launch_counts["field_ew"]
            got = dev.inv(x)
            launches = kernels.launch_counts["field_ew"] - before
            e = max_abs_err(got, dev.inv_ref(x))
            timing = ""
            if n == 2 ** 20:
                timing = f" {cuda_ms(lambda: dev.inv(x), reps=3):.4f} ms (events)"
            print(f"inv p{field.modulus.bit_length()} L={L} {list(shape)}: max_abs_err={e}, "
                  f"{launches} kernel-5 launches{timing}", flush=True)
            require(e == 0, f"inv on the card != inv_ref at L = {L}, shape {shape}")
            require(launches == 2 * (n - 1).bit_length() + 2, f"inv launched {launches} products")
            del got, x


def sass_report(lib_path: str, mangled_part: str):
    """Opcode counts of the compiled kernel whose mangled name contains
    `mangled_part`, from `cuobjdump -sass` of the built library; None where
    cuobjdump is missing or fails."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True)
    if proc.returncode != 0:
        return None
    for body in proc.stdout.split("Function : ")[1:]:
        if mangled_part in body.split("\n", 1)[0]:
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)", body)
            counts = {}
            for op in ops:
                counts[op] = counts.get(op, 0) + 1
            return counts
    return None


def check_probes(device, fields, rng, results):
    """Kernels 10 and 11 against their plain versions at the probes' shapes
    (mont_chain at depth 16 over [L, 2^21] at every L, edge_values among
    the elements; u32_chain over 2^26 words, and over one word for three
    rounds); the reported times are the squaring chain at L = 16 and the
    u32 chain."""
    import numpy as np
    import torch
    from genstark_tpu_torch import kernels, roofline
    from genstark_tpu_torch.testing import edge_values, plant
    for field in fields:
        dev = field.device_field(device)
        n, depth = 2 ** 21, 16
        x = dev.from_numpy(plant(field, random_elements(rng, field.modulus, dev.L, n),
                                 edge_values(field), 0))
        e = max_abs_err(kernels.mont_chain(dev, x, depth), roofline.mont_chain_ref(dev, x, depth))
        require(e == 0, f"mont_chain kernel != plain version at L = {dev.L}")
        results["mont_chain"]["max_abs_err"] = max(results["mont_chain"]["max_abs_err"], e)
        times = ""
        if dev.L == 16:
            km = cuda_ms(lambda: kernels.mont_chain(dev, x, depth))
            pm = cuda_ms(lambda: roofline.mont_chain_ref(dev, x, depth), reps=1)
            results["mont_chain"].update(ms=km, plain_ms=pm, bytes=2 * dev.L * 4 * n,
                                         device_ms=device_ms(
                                             lambda: kernels.mont_chain(dev, x, depth), reps=5),
                                         work=[(("mont", dev.L), depth * n)])
            times = f" kernel {km:.4f} ms plain {pm:.4f} ms"
        print(f"mont_chain L={dev.L} n={n} depth={depth}: max_abs_err={e}{times}", flush=True)
    n = 2 ** 26
    w = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, size=n, dtype=np.int64)
                        .astype(np.int32), device=device)
    e = max_abs_err(kernels.u32_chain(w), roofline.u32_chain_ref(w))
    # the one-thread latency form: one element, three rounds
    e = max(e, max_abs_err(kernels.u32_chain(w[:1], 3), roofline.u32_chain_ref(w[:1], 3)))
    require(e == 0, "u32_chain kernel != plain version")
    km = cuda_ms(lambda: kernels.u32_chain(w))
    pm = cuda_ms(lambda: roofline.u32_chain_ref(w), reps=1)
    results["u32_chain"].update(max_abs_err=e, ms=km, plain_ms=pm, bytes=8 * n,
                                device_ms=device_ms(lambda: kernels.u32_chain(w), reps=5),
                                work=[("u32", n * roofline.U32_OPS_PER_ELEMENT)])
    print(f"u32_chain n={n}: max_abs_err={e} kernel {km:.4f} ms plain {pm:.4f} ms", flush=True)


def check_mont_inv(kernels, device, fields, rng, results):
    """Kernel A against mont_pow_ref(x, p - 2), bit for bit, at every L:
    1000 elements with zero among them in one launch, and inv's [L, 1]
    total alone (against the first column of the same plain result).  The
    reported time is one P256 element (inv's launch); its latency floor is
    the binary GCD's dependent chain (T batches of GCD_STEPS steps and an
    update) at the measured latency of a dependent u32 op."""
    import torch
    r = results["mont_inv"]
    for field in fields:
        dev = field.device_field(device)
        p, L = field.modulus, dev.L
        x = dev.from_numpy(random_elements(rng, p, L, 1000))
        x[:, 500] = 0
        want = dev.mont_pow_ref(x, p - 2)
        err = max(max_abs_err(kernels.mont_inv(dev, x), want),
                  max_abs_err(kernels.mont_inv(dev, x[:, :1]), want[:, :1]))
        require(not want[:, 500].any(), "mont_pow_ref: 0^(p-2) != 0")
        timing = ""
        if L == 16:
            one = x[:, :1].contiguous()
            km = cuda_ms(lambda: kernels.mont_inv(dev, one))
            t0 = time.monotonic()
            dev.mont_pow_ref(one, p - 2)
            torch.cuda.synchronize()
            pm = (time.monotonic() - t0) * 1e3
            batches, k, steps = kernels.mont_inv_constant(p, L)[0], L // 2, kernels.GCD_STEPS
            ops = batches * (steps * GCD_STEP_OPS + 24 * k + 16)
            r.update(ms=km, plain_ms=pm, bytes=2 * 4 * L,
                     work=[("u32", ops), (("mont", L), 1)],
                     chain=batches * (steps * GCD_STEP_CHAIN + 3 * k + 4),
                     device_ms=device_ms(lambda: kernels.mont_inv(dev, one)))
            timing = (f"; one element ({batches} batches of {steps} steps, {r['chain']} "
                      f"dependent ops): kernel {km:.4f} ms (device {fmt_ms(r['device_ms'])}) "
                      f"plain {pm:.4f} ms (one call)")
        print(f"mont_inv p{p.bit_length()} L={L} ([L, 1000] with a zero and [L, 1]): "
              f"max_abs_err={err}{timing}", flush=True)
        require(err == 0, f"mont_inv kernel != plain version at L = {L}")
        r["max_abs_err"] = max(r["max_abs_err"], err)


def check_sample_queries(kernels, device, rng, results):
    """Kernel B against sample_sets_ref, bit for bit: the bench's six sets
    (48 execution positions over 2^17 excluding multiples of 16, 24 a FRI
    layer over 2^15 .. 2^7), a set over 2^32 (indexes above 2^31: the
    int64 case) and two odd-hex seeds whose sets need a second window, from
    seeded roots; the positions also against the host sampler.  The
    reported time is the bench's sets in one launch; its bound counts the
    SHA-256 compressions these seeds need (the state and each candidate up
    to the set's last), and the bytes in and out; its latency floor is two
    dependent compressions (the state's, then a candidate's) at the
    measured latency of a dependent u32 op."""
    import numpy as np
    import torch
    from genstark_tpu_torch.protocol import device_queries as dq
    from genstark_tpu_torch.protocol.queries import get_pseudorandom_indexes
    n_cand = lambda c: 32 * c + 512
    bench = [(48, 2 ** 17, 16, n_cand(48))] + [(24, 2 ** k, 16, n_cand(24))
                                                for k in (15, 13, 11, 9, 7)]
    r = results["sample_queries"]
    odd = [(48, 2 ** 17, 16, n_cand(48)), (24, 2 ** 15, 16, n_cand(24))]
    odd_roots = np.concatenate([odd_hex_roots(rng, 1, *spec[:3]) for spec in odd])
    for label, specs in (("bench", bench), ("max 2^32", [(24, 2 ** 32, 16, n_cand(24))]),
                         ("odd hex, two windows", odd)):
        roots_np = (odd_roots if label.startswith("odd") else
                    rng.integers(-2 ** 31, 2 ** 31, size=(len(specs), 8),
                                 dtype=np.int64).astype(np.int32))
        roots = torch.as_tensor(roots_np, device=device)
        idx, found = kernels.sample_queries(roots, specs)
        want_idx, want_found = dq.sample_sets_ref(roots, specs)
        err = max(max_abs_err(idx, want_idx), max_abs_err(found, want_found))
        seeds = [roots_np[k].view("<u4").tobytes() for k in range(len(specs))]
        host = all(idx[k, :c].tolist() == get_pseudorandom_indexes(seeds[k], c, m, x)
                   for k, (c, m, x, _) in enumerate(specs))
        timing = ""
        if label == "bench":
            km = cuda_ms(lambda: kernels.sample_queries(roots, specs))
            pm = cuda_ms(lambda: dq.sample_sets_ref(roots, specs), reps=2)
            needed = sum(1 + candidates_needed(seeds[k], c, m, x)
                         for k, (c, m, x, _) in enumerate(specs))
            r.update(ms=km, plain_ms=pm, bytes=len(specs) * (32 + 4) + idx.numel() * 8,
                     work=[("u32", needed * SHA256_BLOCK_OPS)],
                     chain=2 * 64 * SHA256_ROUND_CHAIN,
                     device_ms=device_ms(lambda: kernels.sample_queries(roots, specs)))
            # the window (the block's threads) against its two other sizes
            auto, windows = kernels.sample_window, {}
            try:
                for w in (64, 128, 256):
                    kernels.sample_window = lambda c, w=w: w
                    windows[w] = device_ms(lambda: kernels.sample_queries(roots, specs))
            finally:
                kernels.sample_window = auto
            timing = (f" ({needed} compressions needed): kernel {km:.4f} ms (device "
                      f"{fmt_ms(r['device_ms'])}, window {auto(max(c for c, *_ in specs))}; "
                      f"device by window {[(w, fmt_ms(t)) for w, t in windows.items()]}) "
                      f"plain {pm:.4f} ms")
        elif label == "max 2^32":
            require(bool((idx >= 2 ** 31).any()), "no index above 2^31 over max_ = 2^32")
        print(f"sample_queries {label} sets {[(c, m) for c, m, _, _ in specs]}: "
              f"max_abs_err={err}, host sampler {'equal' if host else 'DIFFERS'}{timing}",
              flush=True)
        require(err == 0 and host, f"sample_queries kernel != plain version ({label})")
        r["max_abs_err"] = max(r["max_abs_err"], err)


def host_fallbacks(stark):
    """Proves of this Stark that took the host-sampled path (None for a
    prover without a device sampler)."""
    counts = [getattr(p, "host_fallbacks", None) for p in stark._provers.values()]
    return None if None in counts else sum(counts)


def check_one_fetch(kernels, stark, prove, label: str, sync_log: dict) -> None:
    """One warm prove synchronizes once after its first kernel (the
    proof's fetch), and no prove of the path fell back to the host
    sampler.  One prove first, so that the counted ones replay the
    Prover's recorded graph, as every warm prove does."""
    prove()
    syncs = count_syncs(kernels, prove)
    fallbacks = host_fallbacks(stark)
    sync_log[label] = dict(syncs, host_fallbacks=fallbacks)
    print(f"{label} synchronizing calls in one warm prove: {syncs['syncs']} "
          f"({syncs['after_first_kernel']} after its first kernel); host wait "
          f"{fmt_ms(syncs['host_wait_ms'])} in {syncs['wait_calls']}; sites {syncs['sites']}; "
          f"host_fallbacks {fallbacks}", flush=True)
    require(syncs["after_first_kernel"] == 1,
            f"{label}: {syncs['after_first_kernel']} synchronizing calls after the first kernel")
    require(fallbacks == 0, f"{label}: {fallbacks} proves took the host-sampled path")


def measure_rates(kernels, device, fields) -> dict:
    """The probe path: Montgomery products per second at every L (slope
    between depths 16 and 64 over 2^21 elements) and u32 ops per second,
    with the launch counts set to 0 before and read after."""
    from genstark_tpu_torch import roofline
    kernels.reset_launch_counts()
    rates = {"u32": roofline.u32_rate(device)["u32_ops_per_s"]}
    lat = roofline.u32_latency(device)
    rates["u32_latency_s"] = lat["s_per_op"]
    print(f"probe u32_chain on one thread: {1e9 * lat['s_per_op']:.4f} ns a dependent u32 op "
          f"(rounds {lat['rounds']}: {lat['ms'][0]:.4f} / {lat['ms'][1]:.4f} ms, "
          f"{roofline.U32_DEPENDENT_PER_ROUND} dependent ops a round)", flush=True)
    for field in fields:
        r = roofline.mont_rate(field.device_field(device))
        rates[("mont", r["L"])] = r["mont_muls_per_s"]
        print(f"probe mont_chain L={r['L']} (word product, squares): {r['mont_muls_per_s']:.6e} "
              f"mont-muls/s (depths {r['depths']}: {r['ms'][0]:.4f} / {r['ms'][1]:.4f} ms "
              f"over {r['n']} elements)", flush=True)
    print(f"probe u32_chain: {rates['u32']:.6e} u32 ops/s", flush=True)
    for key, rate in list(rates.items()):
        if isinstance(key, tuple):
            floor = rates["u32"] / roofline.mont_min_u32_ops(key[1])
            print(f"L={key[1]} {key[0]}: this code's {rate:.6e} Montgomery products/s are "
                  f"{100 * rate / floor:.1f}% of the card's {floor:.6e}/s "
                  f"({roofline.mont_min_u32_ops(key[1])} 32-bit multiplies each at the u32 rate)",
                  flush=True)
    rates["launches"] = {k: kernels.launch_counts[k] for k in PROBE_KERNELS}
    return rates


def work_seconds(kind, count: int, rates: dict) -> float:
    """Least seconds of `count` units of work on the card: int8 digit ops at
    the tensor-core rate; u32 ops at the u32 probe's rate; Montgomery
    products at L limbs as their least 32-bit multiplies
    (roofline.mont_min_u32_ops) at that same rate."""
    from genstark_tpu_torch.roofline import mont_min_u32_ops
    if kind == "int8_mma":
        return count / INT8_OPS_PER_S
    if kind == "u32":
        return count / rates["u32"]
    return count * mont_min_u32_ops(kind[1]) / rates["u32"]


def bound(entry: dict, rates: dict):
    """(bound_ms, bound_by, own_ms): the larger of the bytes over the memory
    rate and the work at the card's rates; and the Montgomery part of the
    work at this code's own product rate (the mont_chain probe's word
    product), None where there is none."""
    t_bytes = entry["bytes"] / MEM_BYTES_PER_S
    t_ops = sum(work_seconds(kind, count, rates) for kind, count in entry["work"])
    mont = [count / rates[kind] for kind, count in entry["work"] if isinstance(kind, tuple)]
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            1e3 * sum(mont) if mont else None)


def check_large_transforms(kernels, device, field, rng) -> None:
    """The LARGE_N-point P256 transform (R^-1 folded, as the prover's LDE)
    through the direct route, the four-step route and the plain route: all
    three equal, both kernel routes timed.  Then 2 and 4 times LARGE_N:
    forward then inverse through the direct route returns the input."""
    import torch
    from genstark_tpu_torch.ntt import radix2
    dev = field.device_field(device)
    L, p = dev.L, field.modulus
    n = LARGE_N
    root, r_inv = field.get_root_of_unity(n), field.inv(field.params.R_mod % p)
    direct = radix2.Radix2Plan(field, dev, n, root, r_inv)
    saved = radix2.DIRECT_ABOVE
    radix2.DIRECT_ABOVE = n
    try:
        four = radix2.Radix2Plan(field, dev, n, root, r_inv)
    finally:
        radix2.DIRECT_ABOVE = saved
    require((direct.route, four.route) == ("direct", "four_step"), "2^22 routes")
    x = dev.from_numpy(random_elements(rng, field.modulus, L, n)).reshape(1, L, n)
    kernels.reset_launch_counts()
    got = radix2.transform(dev, x, direct)
    torch.cuda.synchronize()
    one = {k: v for k, v in kernels.launch_counts.items() if v}
    e4 = max_abs_err(got, radix2.transform(dev, x, four))
    ep = max_abs_err(got, radix2.transform_ref(dev, x, direct))
    d_ms = cuda_ms(lambda: radix2.transform(dev, x, direct), reps=3)
    f_ms = cuda_ms(lambda: radix2.transform(dev, x, four), reps=3)
    print(f"P256 {n}-point transform (R^-1 folded): direct vs four-step max_abs_err={e4}, "
          f"direct vs plain max_abs_err={ep}; direct route {d_ms:.4f} ms, four-step route "
          f"{f_ms:.4f} ms; launches of one direct transform {one}", flush=True)
    require(e4 == 0 and ep == 0, f"{n}-point transform: the routes disagree")
    split = sum(m > kernels.STAGE_SPLIT_ABOVE for m, _ in direct.passes)
    want = {"butterfly": 1, "bfly_stage": len(direct.passes) - split, "bfly_stage_split": split}
    require(len(direct.passes) <= 2, f"{n}-point direct transform in passes {direct.passes}")
    require(all(one.get(k, 0) == v for k, v in want.items()),
            f"{n}-point direct transform launches {one}, expected {want}")
    del direct, four, x, got
    torch.cuda.empty_cache()
    for n in (2 * LARGE_N, 4 * LARGE_N):
        root = field.get_root_of_unity(n)
        fwd = radix2.Radix2Plan(field, dev, n, root)
        inv = radix2.Radix2Plan(field, dev, n, field.inv(root), field.inv(n))
        x = dev.from_numpy(random_elements(rng, field.modulus, L, n)).reshape(1, L, n)
        t0 = time.monotonic()
        back = radix2.transform(dev, radix2.transform(dev, x, fwd), inv)
        torch.cuda.synchronize()
        e = max_abs_err(back, x)
        print(f"P256 {n}-point direct transform + inverse: max_abs_err={e} "
              f"({(time.monotonic() - t0) * 1e3:.3f} ms with the first launch)", flush=True)
        require(e == 0, f"{n}-point round trip does not return its input")
        del fwd, inv, x, back
        torch.cuda.empty_cache()


def check_route_times(kernels, device, field, sizes, smi_line: str) -> dict:
    """The LDE transforms of `sizes` points (R^-1 folded, one [1, L, n]
    polynomial) on both routes in this one call: the plan `make_plan` gives
    (the digit route, kernel 1) and a `Radix2Plan` built directly (the
    direct route: kernel 8 and the stage passes).  For P256 the LDEs of the
    mimc256-2^18 and -2^20 paths (LARGE_N and 4 LARGE_N points); for the
    192-bit solinas field that of mimc192-2^18 (LARGE_N).  Both equal; each
    timed by CUDA events (the wrapper's torch ops included) and by its port
    kernels' device time (`large_ms`).  Prints and returns {"2^k": {route:
    {...}}}."""
    import torch
    from genstark_tpu_torch.ntt import DftPlan, make_plan, radix2, transform
    dev = field.device_field(device)
    L, p = dev.L, field.modulus
    name = f"p{p.bit_length()}"
    r_inv = field.inv(field.params.R_mod % p)
    out = {}
    for n in sizes:
        root = field.get_root_of_unity(n)
        plans = {"digit": make_plan(field, dev, n, root, r_inv),
                 "radix2": radix2.Radix2Plan(field, dev, n, root, r_inv)}
        require(isinstance(plans["digit"], DftPlan),
                f"make_plan gave {name} a {type(plans['digit']).__name__}")
        x = device_elements(device, 70 + n.bit_length(), p, L, 1, n).transpose(0, 1).contiguous()
        e = max_abs_err(transform(dev, x, plans["digit"]), transform(dev, x, plans["radix2"]))
        require(e == 0, f"{name} {n}-point LDE: the digit and radix-2 routes disagree")
        row = {"max_abs_err": e}
        for route, plan in plans.items():
            kernels.reset_launch_counts()
            transform(dev, x, plan)
            torch.cuda.synchronize()
            launches = {k: v for k, v in kernels.launch_counts.items() if v}
            em, dm = large_ms(lambda: transform(dev, x, plan))
            shape = list(plan.levels) if route == "digit" else [plan.route, plan.passes]
            row[route] = {"ms": em, "device_ms": dm, "launches": launches, "shape": shape}
            print(f"{name} (L = {L}) {n}-point LDE (R^-1 folded) on the {route} route {shape}: "
                  f"events {em:.4f} ms, port kernels' device time {fmt_ms(dm)}; launches "
                  f"{launches}", flush=True)
        out[f"2^{n.bit_length() - 1}"] = row
        del plans, x
        torch.cuda.empty_cache()
    print(json.dumps({f"{name}_routes": out, "device": smi_line}), flush=True)
    return out


def device_elements(device, seed: int, modulus: int, L: int, *shape):
    """int32 [L, *shape] canonical limbs made on the card from `seed`
    (random_elements' rule: the top limb below the modulus's top limb)."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randint(0, 1 << 16, (L,) + shape, generator=g, device=device, dtype=torch.int32)
    x[L - 1] = torch.randint(0, modulus >> (16 * (L - 1)), shape, generator=g, device=device,
                             dtype=torch.int32)
    return x


def chunked_err(got, plain, n: int, chunk: int = 1 << 21) -> int:
    """max |got - plain| over the last axis [0, n) in chunks, plain(i0, i1)
    giving the plain version's columns [i0, i1)."""
    return max(max_abs_err(got[..., i0:min(n, i0 + chunk)], plain(i0, min(n, i0 + chunk)))
               for i0 in range(0, n, chunk))


def ladder_plans(field, dev, steps=LADDER_STEPS[1:]):
    """(label, DftPlan) of the two transforms of each path of `steps` (by
    default the ladder's 2^20- and 2^21-step paths; the MiMC-256 paths'
    2^18 and 2^20) that carry a level-1 scale, as the prover makes them
    (`Prover._plan_specs`): the LDE to Ne = 16 T with R^-1 folded
    ("w_Ne_std": four levels of 64 at 2^24, five of 32 at 2^25) and the
    trace's iNTT with T^-1 folded ("w_T_inv")."""
    from genstark_tpu_torch.ntt import DftPlan
    f, p = field.host, field.modulus
    plans = []
    for T in reversed(steps):
        Ne = 16 * T
        plans.append((f"LDE 2^{Ne.bit_length() - 1} (R^-1)", DftPlan(
            field, dev, Ne, f.get_root_of_unity(Ne), f.inv(field.params.R_mod % p))))
        plans.append((f"iNTT 2^{T.bit_length() - 1} (T^-1)", DftPlan(
            field, dev, T, f.inv(f.get_root_of_unity(T)), f.inv(T % p))))
    return plans


def check_largest_shapes(device, field, Ne: int, results, rates=None, dft_plans=(),
                         radix2_too: bool = False):
    """Each kernel of a large path against its plain version at that path's
    largest shapes, Ne evaluation points at the field's L: the [2, L, Ne]
    evaluation vectors hold 2^29 elements (2^31 bytes) both for MiMC-256 at
    2^20 steps (Ne = 2^24, L = 16) and for MiMC-128 at 2^21 steps (Ne =
    2^25, L = 8).  Kernel 5 on [L, Ne] and on the [L, 2, Ne] view of a
    [2, L, Ne] tensor (the direct route's scale multiply) with a scalar on
    either side; kernel 6 at the Ne/2-point table's factors; kernel 3 over
    the Ne leaves of two vectors and the first FRI layer's Ne/4 rows; kernel
    2 over the e-tree's first level (Ne/2 pairs); kernel 4 at Ne with the
    prover's split s; kernel B at the path's query sets (48 positions over
    Ne, 24 over each FRI layer's Ne/4^k).  On the digit route (every
    solinas field), kernel 1 at every level of each plan of `dft_plans`
    ((label, DftPlan): `check_dft_chain`); on the radix-2 route (and with
    `radix2_too` on a digit field as well), kernel 8's bit-reversed pass and
    the direct route's stage passes over [2, L, Ne].
    The plain versions
    run on column (or block) chunks where an output column reads only its
    own input columns; kernel 6's and the stages' plain versions run whole.
    With `rates`, the time of kernels 1-6 (and of 8 and 7/9 on the radix-2
    route) at these shapes, whose operands lie far past the card's 50 MB L2,
    beside their bounds (`large_ms`): returns {kernel: (events ms, device
    ms, bound ms, bound by)}."""
    import torch
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.hash import create_hash, digest_rows_ref, elements_to_words
    from genstark_tpu_torch.ntt import digit_dft_field, radix2
    from genstark_tpu_torch.protocol import device_queries as dq
    from genstark_tpu_torch.protocol.lincomb_kernel import lcomb_tail, lcomb_tail_ref
    dev = field.device_field(device)
    L, p, elem = dev.L, field.modulus, field.element_size
    split = lambda n: 1 << ((n.bit_length() - 1) // 2)                # the plans' s
    chunk = Ne // 8
    seeds = iter(range(20, 40))
    rnd = lambda *shape: device_elements(device, next(seeds), p, L, *shape)
    cols = lambda t, i0, i1: t[..., i0:i1] if t.shape[-1] > 1 else t    # a scalar stays
    where = f"Ne = {Ne}, L = {L}"
    times = {}

    def note(name, e, what):
        print(f"{name} at {where}, {what}: max_abs_err={e}", flush=True)
        require(e == 0, f"{name} kernel != plain version at {what} ({where})")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)

    def timed(name, fn, cost):
        if rates is None:
            return
        em, dm = large_ms(fn)
        bound_ms, bound_by, _ = bound(cost, rates)
        times[name] = (em, dm, bound_ms, bound_by)
        print(f"{name} at {where}: events {em:.4f} ms, device {fmt_ms(dm)}, against a bound "
              f"of {bound_ms:.4f} ms ({bound_by})", flush=True)

    a, b, c = rnd(Ne), rnd(Ne), rnd(1)
    e_std = rnd(2, Ne).transpose(0, 1).contiguous()                  # [2, L, Ne]
    ev = e_std.transpose(0, 1)                                        # [L, 2, Ne] view
    for op, ref in (("mul", dev.mont_mul_ref), ("add", dev.add_ref), ("sub", dev.sub_ref)):
        err = 0
        for x, y in ((a, b), (ev, c), (c, ev)):
            err = max(err, chunked_err(kernels.field_ew(dev, op, x, y), lambda i0, i1: ref(
                cols(x, i0, i1), cols(y, i0, i1)), Ne, chunk))
        note("field_ew", err, f"{op} [{L}, {Ne}] and [{L}, 2, {Ne}] x scalar")
    timed("field_ew", lambda: kernels.field_ew(dev, "mul", a, b),
          {"bytes": 3 * L * 4 * Ne, "work": [(("mont", L), Ne)]})

    s = split(Ne // 2)
    outer, inner = rnd(Ne // 2 // s), rnd(s)
    note("outer_table", max_abs_err(kernels.outer_table(dev, outer, inner),
                                    dev.outer_table_ref(outer, inner)), f"{Ne // 2 // s} x {s}")
    timed("outer_table", lambda: kernels.outer_table(dev, outer, inner),
          outer_cost(L, Ne // 2 // s, s))
    del outer, inner

    algo = "blake2s256"
    h = create_hash(algo)
    err = chunked_err(h.merge_element_rows(e_std, elem), lambda i0, i1: digest_rows_ref(
        algo, torch.cat([elements_to_words(e_std[v][:, i0:i1]) for v in range(2)]), 2 * elem), Ne, chunk)
    M = Ne // 4
    err = max(err, chunked_err(h.digest_stride_rows(a, elem), lambda i0, i1: digest_rows_ref(
        algo, torch.cat([elements_to_words(a[:, k * M + i0:k * M + i1]) for k in range(4)]),
        4 * elem), M, chunk))
    note("hash_limbs", err, f"{Ne} leaves of [2, {L}, {Ne}], {M} stride-4 rows")
    timed("hash_limbs", lambda: h.merge_element_rows(e_std, elem), limbs_cost(2, L, Ne))
    timed("hash_limbs rows", lambda: h.digest_stride_rows(a, elem), limbs_cost(4, L, M))
    # [16, Ne/2] words: a's limbs where L >= 8, else ceil(8 / L) fresh vectors
    words = (a if L >= 8 else rnd(-(-8 // L), Ne)).reshape(-1)[:16 * (Ne // 2)].view(16, Ne // 2)
    note("hash_words", chunked_err(kernels.hash_words(algo, words, 64),
                                   lambda i0, i1: digest_rows_ref(algo, words[:, i0:i1], 64),
                                   Ne // 2, chunk), f"{Ne // 2} 64-byte pairs")
    timed("hash_words", lambda: kernels.hash_words(algo, words, 64),
          {"bytes": (64 + 32) * (Ne // 2), "work": [("u32", (Ne // 2) * BLAKE2S_BLOCK_OPS)]})

    s, ext = split(Ne), 16
    qe, b_stack = a, rnd(1, Ne).transpose(0, 1).contiguous()          # [1, L, Ne]
    dom, incr = (rnd(Ne // s), rnd(s)), (rnd(Ne // s), rnd(s))
    inv_series, b_coeffs, l_coeffs = rnd(ext), rnd(2), rnd(4)
    x_last = p - 12345
    args = (dev, qe, b_stack, e_std, dom, incr, inv_series, x_last, b_coeffs, l_coeffs,
            True, True, ext)
    tail = lcomb_tail(*args)
    note("lcomb_tail", chunked_err(tail, lambda i0, i1: lcomb_tail_ref(
        dev, qe[:, i0:i1], b_stack[..., i0:i1], e_std[..., i0:i1],
        (dom[0][:, i0 // s:i1 // s], dom[1]), (incr[0][:, i0 // s:i1 // s], incr[1]),
        inv_series, x_last, b_coeffs, l_coeffs, True, True, ext), Ne, chunk),
        f"Ne = {Ne}, B = 1, V = 2, s = {s}")
    del tail
    timed("lcomb_tail", lambda: lcomb_tail(*args), tail_cost(args))
    del args, b_stack, b, words

    n_cand = lambda count: 32 * count + 512                           # Prover._n_cand
    specs = [(48, Ne, ext, n_cand(48))] + [(24, 1 << k, ext, n_cand(24))
                                           for k in range(Ne.bit_length() - 3, 6, -2)]
    g = torch.Generator(device=device)
    g.manual_seed(Ne)
    roots = torch.randint(-2 ** 31, 2 ** 31 - 1, (len(specs), 8), generator=g, device=device,
                          dtype=torch.int32)
    got, want = kernels.sample_queries(roots, specs), dq.sample_sets_ref(roots, specs)
    note("sample_queries", max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1])),
         f"{len(specs)} sets, max_ {[m for _, m, _, _ in specs]}")

    if digit_dft_field(field):
        for label, plan in dft_plans:
            t0 = time.monotonic()
            chain = check_dft_chain(device, field, plan, label, results, rates)
            print(f"dft_level {label}: {len(plan.levels)} levels {plan.levels} checked in "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
            if chain is not None:
                times[f"dft_level {label}"] = chain + ("the levels' sum",)
                print(f"dft_level {label}: events {chain[0]:.4f} ms, device {fmt_ms(chain[1])} "
                      f"over its {len(plan.levels)} levels against a bound of {chain[2]:.4f} ms",
                      flush=True)
    if radix2_too or not digit_dft_field(field):
        local = radix2.LOCAL_MAX
        table = rnd(local // 2)
        blocks = lambda t: t.view(2, L, Ne // local, local).permute(0, 2, 1, 3)
        got = e_std.clone()
        kernels.butterfly(dev, blocks(got), table, out=blocks(got), bitrev_in=True)
        gc = Ne // local // 8
        err = max(max_abs_err(blocks(got)[:, g0:g0 + gc], radix2.butterfly_ref(
            dev, blocks(e_std)[:, g0:g0 + gc], table, bitrev_in=True))
            for g0 in range(0, Ne // local, gc))
        note("butterfly", err, f"bit-reversed entry over [2, {L}, {Ne}] in blocks of {local}")
        # [2, L, Ne] read and written once, the table read; (local/2)
        # log2(local) products a block
        timed("butterfly", lambda: kernels.butterfly(dev, blocks(got), table, out=blocks(got),
                                                     bitrev_in=True),
              {"bytes": 2 * 2 * L * 4 * Ne + L * 4 * (local // 2),
               "work": [(("mont", L), 2 * (Ne // 2) * (local.bit_length() - 1))]})
        del got
        table = rnd(Ne // 2).t().contiguous()                           # [Ne/2, L]
        for m, k in radix2.stage_passes(Ne, local, radix2.PASS_DEPTH):
            row = "bfly_stage" if m <= kernels.STAGE_SPLIT_ABOVE else "bfly_stage_split"
            got = kernels.butterfly_stages(dev, e_std.clone(), table, m, k)
            note(row, max_abs_err(got, radix2.butterfly_stages_ref(dev, e_std.clone(), table,
                                                                   m, k)),
                 f"stages m = {m} .. {m << (k - 1)} over [2, {L}, {Ne}]")
            # the array read and written once, the last stage's m << (k - 1)
            # twiddles read; k * Ne/2 products a vector
            timed(f"{row} m = {m}, k = {k}",
                  lambda: kernels.butterfly_stages(dev, got, table, m, k),
                  {"bytes": 2 * 2 * L * 4 * Ne + L * 4 * (m << (k - 1)),
                   "work": [(("mont", L), 2 * k * (Ne // 2))]})
            del got
        del table
    del a, c, e_std, ev
    torch.cuda.empty_cache()
    return times


def profile_prove(stark, assertions, inputs, stats: dict = None) -> dict:
    """Device kernel time by name over one prove, and the device's busy
    share of the wall time; returns port_totals of the profile (and puts
    the wall, device and busy share into `stats`, where given).  A
    measurement only: a profiler that captures nothing is reported, not
    fatal."""
    try:
        by_name, stages, wall_ms = profile_run(lambda: stark.prove(assertions, inputs))
    except Exception as err:  # noqa: BLE001 - measurement boundary
        print(f"profiler failed: {err!r}", flush=True)
        return {}
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    if stats is not None:
        stats.update(profiled_wall_ms=wall_ms, device_ms=busy_ms,
                     busy_pct=100 * busy_ms / wall_ms,
                     launches_recorded=sum(n for _, n in by_name.values()))
    print(f"profiled prove wall {wall_ms:.3f} ms, device kernels {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% busy), {sum(n for _, n in by_name.values())} "
          f"kernel launches", flush=True)
    radix = [(us, n) for name, (us, n) in by_name.items() if "butterfly" in name]
    print(f"  radix-2 kernels 7 + 8 + 9: {sum(us for us, _ in radix) / 1e3:.3f} ms over "
          f"{sum(n for _, n in radix)} launches", flush=True)
    for short, (us, n) in sorted(port_totals(by_name).items(), key=lambda kv: -kv[1][0]):
        print(f"  port kernel {short}: {us / 1e3:.3f} ms over {n} launches", flush=True)
    for name, us in stages.items():
        print(f"  stage {name}: host wall {us / 1e3:.3f} ms", flush=True)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / 1e3:9.3f} ms {n:6d}x  {name[:100]}", flush=True)
    return port_totals(by_name)


def port_totals(by_name: dict) -> dict:
    """{short kernel name: (us, launches)} over the port's kernels of a
    profile (every instantiation of a kernel summed)."""
    out = {}
    for name, (us, n) in by_name.items():
        if is_port_kernel(name):
            key = short_kernel_name(name)
            t, c = out.get(key, (0.0, 0))
            out[key] = (t + us, c + n)
    return out


def kernel_times(device, rates) -> dict:
    """Device time (torch.profiler) of kernels 1, 3, 4 and 6 at the main
    paths' shapes, through the port's entry points: the three kernel-1
    levels of one p128 2^17-point LDE (ntt.transform; also every device
    kernel of the transform, with torch's own), kernel 4 at Ne = 2^17, L = 8
    and at the 2^18-step path's Ne = LARGE_N, L = 16 (B = 1, V = 2, both
    raised copies, the prover's split s; beside its bound), kernel 6 at a
    2^22-product table (nj = s = 2048, L = 16), kernel 3 at the 2^18-step
    path's LARGE_N leaves of two P256 elements and at a late FRI layer's 512
    p128 rows (beside their bounds), and one profiled bench prove after a
    warm-up: the totals of kernels 1, 3, 4 and 6, all device kernels and
    their launches."""
    import torch
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.field import P128, P256, create_prime_field
    from genstark_tpu_torch.ntt import DftPlan, transform
    from genstark_tpu_torch.protocol.lincomb_kernel import lcomb_tail
    from mimc_torch import make_mimc_stark
    out = {}
    f128 = create_prime_field(P128)
    dev = f128.device_field(device)
    n = 2 ** 17
    plan = DftPlan(f128, dev, n, f128.get_root_of_unity(n),
                   f128.inv(f128.params.R_mod % f128.modulus))
    x = device_elements(device, 90, f128.modulus, dev.L, n).reshape(1, dev.L, n)
    transform(dev, x, plan)
    torch.cuda.synchronize()
    reps = 20
    by_name = profile_run(lambda: transform(dev, x, plan), reps)[0]
    k1 = [(us, c) for name, (us, c) in by_name.items() if "dft_level" in name]
    # the mean over the recorded launches times the plan's levels (the
    # profiler may miss a launch or two)
    n_k1 = sum(c for _, c in k1)
    out["dft_lde_2_17_device_ms"] = (sum(us for us, _ in k1) / n_k1 * len(plan.levels) / 1e3
                                     if n_k1 else None)
    out["dft_lde_2_17_launches_recorded"] = sum(c for _, c in k1) / reps
    out["lde_2_17_all_device_ms"] = sum(us for us, _ in by_name.values()) / 1e3 / reps
    out["lde_2_17_all_launches_recorded"] = sum(c for _, c in by_name.values()) / reps
    for label, modulus, Ne in (("tail_2_17_l8", P128, 2 ** 17), ("tail_2_22_l16", P256, LARGE_N)):
        field = create_prime_field(modulus)
        dev = field.device_field(device)
        L, p = dev.L, field.modulus
        s, ext = 1 << ((Ne.bit_length() - 1) // 2), 16
        seeds = iter(range(100, 120))
        rnd = lambda *shape: device_elements(device, next(seeds), p, L, *shape)
        args = (dev, rnd(Ne), rnd(1, Ne).transpose(0, 1).contiguous(),
                rnd(2, Ne).transpose(0, 1).contiguous(), (rnd(Ne // s), rnd(s)),
                (rnd(Ne // s), rnd(s)), rnd(ext), p - 12345, rnd(2), rnd(4), True, True, ext)
        out[f"{label}_device_ms"] = device_ms(lambda: lcomb_tail(*args), reps=10)
        bound_ms, bound_by, own_ms = bound(tail_cost(args), rates)
        print(f"lcomb_tail Ne={Ne} L={L} B=1 V=2 s={s}: device "
              f"{fmt_ms(out[label + '_device_ms'])} against a bound of {bound_ms:.4f} ms "
              f"({bound_by}); its products at the word product's rate {own_ms:.4f} ms",
              flush=True)
        del args
        torch.cuda.empty_cache()
    f256 = create_prime_field(P256)
    dev = f256.device_field(device)
    nj = s = 2048
    outer, inner = (device_elements(device, 130 + i, f256.modulus, dev.L, n)
                    for i, n in enumerate((nj, s)))
    out["outer_2_22_l16_device_ms"] = device_ms(lambda: dev.outer_table(outer, inner), reps=10)
    bound_ms, bound_by, own_ms = bound(outer_cost(dev.L, nj, s), rates)
    print(f"outer_table nj={nj} s={s} L={dev.L}: device "
          f"{fmt_ms(out['outer_2_22_l16_device_ms'])} against a bound of {bound_ms:.4f} ms "
          f"({bound_by}); its products at the word product's rate {own_ms:.4f} ms", flush=True)
    del outer, inner
    for label, field, form, batch in (("leaves_2_22_p256", f256, 2, LARGE_N),
                                      ("rows_512_p128", f128, "rows", 512)):
        values = limbs_values(device, 140, field, form, batch)
        key = f"hash_limbs_{label}_device_ms"
        out[key] = device_ms(lambda: kernels.hash_limbs("blake2s256", values, form == "rows"),
                             reps=10)
        V = 4 if form == "rows" else form
        bound_ms, bound_by, _ = bound(limbs_cost(V, field.params.L, batch), rates)
        print(f"hash_limbs blake2s {label} ({batch} messages of {V} elements): device "
              f"{fmt_ms(out[key])} against a bound of {bound_ms:.4f} ms ({bound_by})", flush=True)
        del values
    torch.cuda.empty_cache()
    stark, constants = make_mimc_stark(BENCH_STEPS, device)
    assertions = mimc_assertions(stark, constants, BENCH_STEPS)
    for _ in range(2):
        stark.prove(assertions, [[3]])
    torch.cuda.synchronize()
    by_name = profile_run(lambda: stark.prove(assertions, [[3]]))[0]
    totals = port_totals(by_name)
    for key, short in (("bench_dft_level", "dft_level_kernel"),
                       ("bench_lcomb_tail", "lcomb_tail_kernel"),
                       ("bench_hash_limbs", "digest_limbs_kernel"),
                       ("bench_outer_table", "outer_table_kernel")):
        us, c = totals.get(short, (0.0, 0))
        out[f"{key}_device_ms"], out[f"{key}_launches"] = us / 1e3, c
    out["bench_all_device_ms"] = sum(us for us, _ in by_name.values()) / 1e3
    out["bench_all_launches"] = sum(c for _, c in by_name.values())
    for name, (us, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"  bench prove, device: {us / 1e3:9.3f} ms {c:6d}x  {name[:90]}", flush=True)
    return out


def proof_digest(data: bytes):
    return len(data), hashlib.sha256(data).hexdigest()


def mimc_assertions(stark, constants, steps: int):
    from mimc_torch import run_mimc
    from genstark_tpu_torch.protocol import Assertion
    controls = run_mimc(stark.air.field, steps, constants, 3)
    return [Assertion(0, 0, controls[0]), Assertion(steps - 1, 0, controls[-1])]


def verify_proof(stark, assertions, data: bytes, public, label: str, reps: int = 0):
    """The port's verifier on `data`: parse(serialize) gives the same bytes
    and verify accepts it; with reps > 0, verify_ms as bench.py measures it,
    the best of `reps` after one warm-up.  Returns verify_ms or None."""
    parsed = stark.parse(data)
    require(stark.serialize(parsed) == data, f"{label}: parse + serialize changed the bytes")
    require(stark.verify(assertions, parsed, public) is True, f"{label}: verify failed")
    if not reps:
        return None
    times = []
    for _ in range(reps):
        parsed = stark.parse(data)
        t0 = time.monotonic()
        stark.verify(assertions, parsed, public)
        times.append((time.monotonic() - t0) * 1e3)
    print(f"{label} verify_ms best of {reps} {min(times):.3f} (all {[round(t, 3) for t in times]})",
          flush=True)
    return min(times)


def require_native(stark, label: str) -> float:
    """The last prove's trace came from the native generator; its seconds."""
    ctx = stark.last_context
    require(ctx.trace_source == "native", f"{label}: trace from {ctx.trace_source}, not native")
    return ctx.trace_seconds


def run_main_path(kernels, stark, assertions, inputs, pin, required, label: str,
                  sync_log: dict, public=None, stats: dict = None):
    """One main path: a warm-up prove (with the g++ build of the schema's
    trace generator); the launch counts set to 0, one prove checked against
    its pin (where there is one), the counts and the peak device memory
    read, every plain version's calls counted (there must be none); the
    proof parsed, re-serialized and verified (verify_ms best of 5); the
    synchronizing calls of one warm prove and the host-sampled fallbacks
    (`check_one_fetch`, into sync_log); one profiled prove (its wall,
    device time and busy share, with the peak device memory, into `stats`
    where given).  Whole-prove seconds are the benchmark's (`python3 -m
    benchmark.run`).  Returns (launches, proof bytes, the profile's port
    kernel totals)."""
    import torch
    from genstark_tpu_torch.native import tracegen
    built = dict(tracegen.build_seconds)
    t0 = time.monotonic()
    stark.prove(assertions, inputs)
    torch.cuda.synchronize()
    warmup = time.monotonic() - t0
    builds = {k: round(v, 3) for k, v in tracegen.build_seconds.items() if k not in built}
    print(f"{label} warmup {warmup:.4f} s; g++ build of the trace generator in it: "
          f"{builds or 'cached'} s; warm-up trace {require_native(stark, label):.6f} s; "
          f"security {stark.security_level}", flush=True)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with plain_calls() as plain:
        data = stark.serialize(stark.prove(assertions, inputs))
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    require_native(stark, label)
    got = proof_digest(data)
    print(f"{label} proof: {got[0]} bytes sha256 {got[1]}", flush=True)
    print(f"{label} launches in one prove: {launches}; plain-version calls {plain or 0}",
          flush=True)
    require(not plain, f"{label}: the prove on the card ran plain versions {plain}")
    print(f"{label} peak device memory in one prove: {peak} bytes ({peak / 2 ** 30:.3f} GiB)",
          flush=True)
    if pin is not None:
        require(got == pin, f"{label} proof differs from its pin {pin}")
    check_launches(label, launches, required)
    verify_proof(stark, assertions, data, public, label, reps=5)
    check_one_fetch(kernels, stark, lambda: stark.prove(assertions, inputs), label, sync_log)
    phase(f"{label}: where the time goes (torch.profiler, one prove)")
    if stats is not None:
        stats["peak_bytes"] = peak
    totals = profile_prove(stark, assertions, inputs, stats)
    if stats is not None:
        stats["port_kernels_ms"] = {short: [us / 1e3, n] for short, (us, n) in totals.items()}
    return launches, data, totals


def four_step_proof(device, steps: int, modulus: int) -> bytes:
    """The same MiMC proof over a radix-2 field (P64) on a fresh Stark
    whose transforms all take the four-step route (the direct route's
    threshold raised past Ne while its plans are made, at the first
    prove)."""
    from mimc_torch import make_mimc_stark
    from genstark_tpu_torch.ntt import radix2
    stark, constants = make_mimc_stark(steps, device, modulus=modulus)
    saved = radix2.DIRECT_ABOVE
    radix2.DIRECT_ABOVE = steps * stark.air.extension_factor            # Ne
    try:
        data = stark.serialize(stark.prove(mimc_assertions(stark, constants, steps), [[3]]))
    finally:
        radix2.DIRECT_ABOVE = saved
    require_native(stark, "four-step")
    plans = next(iter(stark._provers.values()))._get_plans()
    routes = {k: p.route for k, p in plans.items()}
    require("direct" not in routes.values(), f"four-step prove took the direct route: {routes}")
    print(f"four-step routes: {routes}", flush=True)
    return data


def radix2_route_proof(kernels, device, steps: int, modulus: int, label: str):
    """The same MiMC proof (the bench options, secret input 3) on a fresh
    Stark whose transforms all take the radix-2 route: `ntt.digit_dft_field`
    answers no while its plans are made (at the first prove), so a solinas
    field runs kernels 8 and 7/9 where the prover would run kernel 1.  The
    launch counts set to 0 before the prove and read after it; no plain
    version may run, no kernel-1 launch.  Returns (launches, bytes)."""
    import torch
    from mimc_torch import make_mimc_stark
    from genstark_tpu_torch import ntt
    from genstark_tpu_torch.ntt import Radix2Plan
    stark, constants = make_mimc_stark(steps, device, modulus=modulus)
    dev = stark.air.field.device_field(device)
    saved, saved_plans = ntt.digit_dft_field, dev.plans
    ntt.digit_dft_field = lambda field: False
    dev.plans = {}
    kernels.reset_launch_counts()
    try:
        with plain_calls() as plain:
            data = stark.serialize(stark.prove(mimc_assertions(stark, constants, steps), [[3]]))
            torch.cuda.synchronize()
    finally:
        ntt.digit_dft_field, dev.plans = saved, saved_plans
    launches = dict(kernels.launch_counts)
    require_native(stark, f"{label} radix-2")
    plans = next(iter(stark._provers.values()))._get_plans()
    routes = {k: (type(p).__name__, p.route) for k, p in plans.items()}
    print(f"{label} forced onto the radix-2 route: {routes}; launches {launches}; "
          f"plain-version calls {plain or 0}; proof {proof_digest(data)}", flush=True)
    require(all(isinstance(p, Radix2Plan) for p in plans.values()),
            f"{label}: a plan left the radix-2 route: {routes}")
    require(not plain, f"{label} radix-2: the prove on the card ran plain versions {plain}")
    require(launches["dft_level"] == 0, f"{label} radix-2: kernel 1 launched")
    check_launches(f"{label} radix-2", launches, RADIX2_LARGE_KERNELS)
    return launches, data


def run_mid_limb_paths(kernels, device, sync_log: dict, smi_line: str,
                       steps: int = LARGE_STEPS):
    """MiMC over the solinas moduli of 96, 160 and 192 bits (the digit route
    at L = 6, 10 and 12) at `steps` steps, the bench options, secret input
    3: `run_largest` (three one-fetch proves, the 192-bit one against
    MIMC192_18_PIN), `run_staged` (its bytes), then `radix2_route_proof`
    (the same bytes with every transform on kernels 8 and 7/9).  Returns
    ({label: stats}, [launches of each run])."""
    import torch
    from mimc_torch import make_mimc_stark
    from genstark_tpu_torch.field import create_prime_field
    from genstark_tpu_torch.ntt import dft_levels
    from genstark_tpu_torch.testing import SOLINAS96, SOLINAS160, SOLINAS192
    paths, all_launches = {}, []
    for modulus, pin in ((SOLINAS96, None), (SOLINAS160, None), (SOLINAS192, MIMC192_18_PIN)):
        label = f"mimc{modulus.bit_length()}-2^{steps.bit_length() - 1}"
        phase(f"{label}: MiMC over the solinas modulus of {modulus.bit_length()} bits (L = "
              f"{create_prime_field(modulus).params.L}), {steps} steps (Ne = {16 * steps}: the "
              f"digit route, levels {dft_levels(16 * steps)}), one-fetch, staged and forced "
              f"onto the radix-2 route")
        t0 = time.monotonic()
        stark, constants = make_mimc_stark(steps, device, modulus=modulus)
        assertions = mimc_assertions(stark, constants, steps)
        launches, data, stats = run_largest(kernels, stark, assertions, BENCH_KERNELS, label,
                                            sync_log, pin=pin)
        all_launches.append(launches)
        launches, stats["staged"] = run_staged(
            kernels, stark, assertions, [[3]], proof_digest(data), STAGED_DIGIT, label,
            sync_log, smi_line, reps=2)
        all_launches.append(launches)
        del stark
        launches, forced = radix2_route_proof(kernels, device, steps, modulus, label)
        all_launches.append(launches)
        require(forced == data, f"{label}: the digit and radix-2 routes gave different bytes")
        stats["radix2_launches"] = launches
        paths[label] = stats
        del data, forced
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        print(f"{label} phase {time.monotonic() - t0:.1f} s", flush=True)
    return paths, all_launches


def run_largest(kernels, stark, assertions, required, label: str, sync_log: dict, pin=None):
    """A large MiMC path (MiMC-256 at 2^20 steps, or MiMC-128 up the JAX
    package's ladder, both on the digit route): a warm-up,
    then three proves, the launch counts set to 0 before the first and
    read after it, every plain version's calls counted (there must be
    none), each prove's peak device memory and native trace seconds; the
    proofs must be identical and equal to `pin` where there is one, the
    port's verifier must accept them (verify_ms best of 3), and every
    kernel of `required` must have launched; then `check_one_fetch` and one
    profiled prove.  Returns (launches of one prove, proof bytes, stats)."""
    import torch
    t0 = time.monotonic()
    stark.prove(assertions, [[3]])
    torch.cuda.synchronize()
    warmup = time.monotonic() - t0
    kernels.reset_launch_counts()
    times, datas, launches, traces, peaks = [], [], None, [], []
    with plain_calls() as plain:
        for _ in range(3):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            proof = stark.prove(assertions, [[3]])
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
            peaks.append(torch.cuda.max_memory_allocated())
            traces.append(require_native(stark, label))
            if launches is None:
                launches = dict(kernels.launch_counts)
            datas.append(stark.serialize(proof))
            del proof
    peak = max(peaks)
    print(f"{label} peak device memory of each prove: {peaks}", flush=True)
    got = proof_digest(datas[0])
    print(f"{label} proof: {got[0]} bytes sha256 {got[1]}", flush=True)
    print(f"{label} launches in one prove: {launches}; plain-version calls {plain or 0}",
          flush=True)
    print(f"{label} warmup {warmup:.4f} s; prove best-of-3 {min(times):.6f} s, median "
          f"{median(times):.6f} s; prove seconds {[round(t, 6) for t in times]}; peak device "
          f"memory {peak} bytes ({peak / 2 ** 30:.3f} GiB)", flush=True)
    print(f"{label} native trace seconds: {[round(t, 6) for t in traces]}", flush=True)
    require(all(d == datas[0] for d in datas), f"{label}: two proves gave different bytes")
    if pin is not None:
        require(got == pin, f"{label} proof differs from its pin {pin}")
    require(not plain, f"{label}: the prove on the card ran plain versions {plain}")
    verify_ms = verify_proof(stark, assertions, datas[0], None, label, reps=3)
    check_launches(label, launches, required)
    check_one_fetch(kernels, stark, lambda: stark.prove(assertions, [[3]]), label, sync_log)
    phase(f"{label}: where the time goes (torch.profiler, one prove)")
    stats = {"prove_s": times, "best_s": min(times), "median_s": median(times),
             "warmup_s": warmup, "trace_s": traces, "peak_bytes": peak,
             "verify_ms": verify_ms, "launches": launches, "bytes": got[0], "sha256": got[1]}
    totals = profile_prove(stark, assertions, [[3]], stats)
    stats["port_kernels_ms"] = {short: [us / 1e3, n] for short, (us, n) in totals.items()}
    return launches, datas[0], stats


@contextlib.contextmanager
def plain_calls():
    """Counts the calls of every plain version (PLAIN_VERSIONS) made inside
    the block: {qualified name: calls}."""
    import importlib
    counts, saved = {}, []
    for module, owner, names in PLAIN_VERSIONS:
        target = importlib.import_module(module)
        if owner is not None:
            target = getattr(target, owner)
        for name in names:
            fn = getattr(target, name)

            key = f"{module}.{owner}.{name}" if owner else f"{module}.{name}"

            def counted(*args, _fn=fn, _key=key, **kwargs):
                counts[_key] = counts.get(_key, 0) + 1
                return _fn(*args, **kwargs)
            saved.append((target, name, fn))
            setattr(target, name, counted)
    try:
        yield counts
    finally:
        for target, name, fn in saved:
            setattr(target, name, fn)


def median(values):
    return sorted(values)[len(values) // 2]


def check_dist_ntt(mesh, modulus_name: str, n: int) -> dict:
    """distributed_ntt and distributed_intt over the mesh against the
    single-device ntt of the same values (made on the card from n), bit
    for bit: the rank's block of each."""
    import torch
    from genstark_tpu_torch import field as fields
    from genstark_tpu_torch import ntt
    from genstark_tpu_torch.parallel import distributed_intt, distributed_ntt
    f = fields.create_prime_field(getattr(fields, modulus_name))
    dev = f.device_field(mesh.device)
    x = device_elements(mesh.device, n, f.modulus, dev.L, n)
    off, b = mesh.block(n)
    got = distributed_ntt(f, x[:, off:off + b].contiguous(), mesh)
    back = distributed_intt(f, got, mesh)
    want = ntt.ntt(f, x)[:, off:off + b]
    torch.cuda.synchronize()
    return {"ntt_err": max_abs_err(got, want), "intt_err": max_abs_err(back, x[:, off:off + b])}


def check_shard_kernels(prover, mesh) -> dict:
    """Every kernel of the sharded path against its plain version at the
    rank's shard shapes (random operands made on the card): each
    distributed plan's local n1- and n2-point transforms at their column
    batches (kernel 1 or 8) and its twiddle product (kernel 5), the rank's
    slice of a factored table (kernel 6), the evaluation leaves of its block
    and the stride-4 rows of its first FRI layer (kernel 3), the first
    level of its subtree (kernel 2), kernel 4 at its block, and kernel B at
    the path's sets.  Returns {kernel: max_abs_err}."""
    import numpy as np
    import torch
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.hash import digest_rows_ref, elements_to_words
    from genstark_tpu_torch.ntt import radix2, transform
    from genstark_tpu_torch.protocol import device_queries as dq
    dev, field, D = prover.dev, prover.field, mesh.size
    p, L, elem, h = field.modulus, dev.L, field.element_size, prover.hash
    seed = 1000 * (mesh.rank + 1)
    errs = {}

    def note(name, e):
        errs[name] = max(errs.get(name, 0), e)

    for plan in prover._get_plans().values():
        if not plan.distributed:
            continue
        c, a = plan.n2 // D, plan.n1 // D
        for local, n_loc, batch in ((plan.p1, plan.n1, c), (plan.p2, plan.n2, a)):
            x = device_elements(dev.device, seed, p, L, batch, n_loc).transpose(0, 1).contiguous()
            name = "butterfly" if isinstance(local, radix2.Radix2Plan) else "dft_level"
            note(name, max_abs_err(transform(dev, x, local), plain_transform(dev, x, local)))
        # the path's operand: a [L, 1, c, n1] view of the [1, c, L, n1] transform output
        y = device_elements(dev.device, seed + 1, p, L, 1, c, plan.n1)
        y = y.permute(1, 2, 0, 3).contiguous().permute(2, 0, 1, 3)
        note("field_ew", max_abs_err(dev.mont_mul(y, plan.tw), dev.mont_mul_ref(y, plan.tw)))
    for key, t in prover._get_tables().items():
        if t[0] == "factored" and prover._blocked(key):
            outer, inner = prover._parts(key)
            note("outer_table", max_abs_err(dev.outer_table(outer, inner),
                                            dev.outer_table_ref(outer, inner)))
    V = prover.context.schema.trace_width + len(prover.secret_idx)
    blk = prover.Ne // D
    vecs = device_elements(dev.device, seed + 2, p, L, V, blk).transpose(0, 1).contiguous()
    want = digest_rows_ref(h.algorithm, torch.cat([elements_to_words(vecs[v]) for v in range(V)]),
                           V * elem)
    note("hash_limbs", max_abs_err(h.merge_element_rows(vecs, elem), want))
    if prover._fri_sharded[0]:
        rows = prover.Ne // 4 // D
        vals = device_elements(dev.device, seed + 3, p, L, 4 * rows)
        note("hash_limbs", max_abs_err(h.digest_stride_rows(vals, elem),
                                       limbs_plain(h.algorithm, vals, "rows", elem, 0, rows)))
    g = torch.Generator(device=dev.device)
    g.manual_seed(seed + 4)
    leaves = torch.randint(-2 ** 31, 2 ** 31 - 1, (8, blk), generator=g, device=dev.device,
                           dtype=torch.int32)
    pairs = torch.cat([leaves[:, 0::2], leaves[:, 1::2]], dim=0).contiguous()
    note("hash_words", max_abs_err(h.hash_pairs(leaves), digest_rows_ref(h.algorithm, pairs, 64)))
    B = prover.c_poly.b_poly.count
    tail = {"lcomb_tail": {"max_abs_err": 0}}
    check_tail(dev, field, np.random.default_rng(seed), tail,
               record_times=False, shape=(blk, prover.context.extension_factor, B, V))
    note("lcomb_tail", tail["lcomb_tail"]["max_abs_err"])
    specs = prover._sample_specs()
    g.manual_seed(seed + 5)
    roots = torch.randint(-2 ** 31, 2 ** 31 - 1, (len(specs), 8), generator=g,
                          device=dev.device, dtype=torch.int32)
    got, want = kernels.sample_queries(roots, specs), dq.sample_sets_ref(roots, specs)
    note("sample_queries", max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1])))
    torch.cuda.synchronize()
    return errs


def sharded_rank(mesh, paths, ntt_sizes, reps: int, scaling: bool) -> dict:
    """One rank of a sharded phase (run by parallel/launch.run_ranks): per
    path a warm-up prove, then one prove with the launch counts set to 0
    before it and read after it (and every plain version's calls counted:
    none may run), its peak memory and the mesh's exchanges, `reps` timed
    proves, and `check_shard_kernels`; then the distributed_ntt checks at
    ntt_sizes (after the proves, so their plans are not in the proves'
    peaks) and, with `scaling`, measure_ntt_scaling at 2^17 points."""
    import torch
    from mimc_torch import make_mimc_stark
    from genstark_tpu_torch import field as fields
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.parallel.scaling import measure_ntt_scaling
    out = {"rank": mesh.rank, "device": str(mesh.device), "backend": mesh.backend, "paths": {}}
    for label, steps, modulus_name, _, _ in paths:
        stark, constants = make_mimc_stark(steps, mesh.device,
                                           modulus=getattr(fields, modulus_name))
        stark.set_mesh(mesh)
        assertions = mimc_assertions(stark, constants, steps)
        t0 = time.monotonic()
        stark.prove(assertions, [[3]])
        torch.cuda.synchronize()
        warmup = time.monotonic() - t0
        mesh.traffic.clear()
        torch.cuda.reset_peak_memory_stats()
        with plain_calls() as plain:
            kernels.reset_launch_counts()
            data = stark.serialize(stark.prove(assertions, [[3]]))
            launches = dict(kernels.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        traffic = dict(mesh.traffic)
        trace_s = require_native(stark, f"sharded {label}")
        times = []
        for _ in range(reps):
            t0 = time.monotonic()
            stark.prove(assertions, [[3]])
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
        prover = next(iter(stark._provers.values()))
        out["paths"][label] = {
            "bytes": data, "launches": launches, "plain_calls": plain, "peak_bytes": peak,
            "traffic": traffic, "warmup_s": warmup, "prove_s": times, "trace_s": trace_s,
            "host_fallbacks": host_fallbacks(stark), "fri_sharded": prover._fri_sharded,
            "kernel_errs": check_shard_kernels(prover, mesh)}
        del stark, prover
        torch.cuda.empty_cache()
    out["ntt"] = {f"{m}-{n}": check_dist_ntt(mesh, m, n) for m, n in ntt_sizes}
    if scaling:
        out["scaling"] = measure_ntt_scaling(mesh, n=2 ** 17)
    return out


def run_sharded(device, results, smi_line: str, expected: dict) -> dict:
    """The sharded phases: SHARDED_RANKS ranks sharing the card over gloo,
    then one rank over nccl (the bench).  Every rank's proof must equal
    its pin; a path without one takes its one-fetch prove from earlier in
    this call, `expected[label]` = (digest, best prove_s, stark,
    assertions), as its pin, its single-device prove_s and its verifier.
    The port's verifier must accept every proof, every kernel of the path
    must have launched on every rank with no plain version called, every
    collective of COLLECTIVES must have run on every rank (NCCL's one rank
    included), no prove may fall back to the host sampler, and every kernel must equal
    its plain version at the shard shapes (merged into `results`).  Prints
    per-rank launches, peaks and exchanges and the best of 3 sharded
    prove_s beside this call's single-device prove_s; returns the launches
    of the counted proves, summed over the ranks, and the phase's record."""
    import torch
    from mimc_torch import make_mimc_stark
    from genstark_tpu_torch import field as fields
    from genstark_tpu_torch import ntt
    from genstark_tpu_torch.parallel.launch import run_ranks
    from genstark_tpu_torch.parallel.scaling import comm_compute_split
    single, starks = {}, {}
    for label, steps, modulus_name, _, _ in SHARDED_PATHS:
        if label in expected:
            _, single[label], *starks[label] = expected[label]
            continue
        stark, constants = make_mimc_stark(steps, device, modulus=getattr(fields, modulus_name))
        assertions = mimc_assertions(stark, constants, steps)
        stark.prove(assertions, [[3]])
        times = []
        for _ in range(3):
            t0 = time.monotonic()
            stark.prove(assertions, [[3]])
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
        single[label] = min(times)
        starks[label] = (stark, assertions)
    f128 = fields.create_prime_field(fields.P128)
    x = device_elements(device, 7, f128.modulus, 8, 2 ** 17)
    single_ntt_s = cuda_ms(lambda: ntt.ntt(f128, x)) / 1e3
    torch.cuda.empty_cache()

    launches = {}
    record = {"label": f"{SHARDED_RANKS} ranks sharing one card, gloo", "device": smi_line,
              "single_prove_s": single}
    for world, backend, paths, ntt_sizes, reps in (
            (SHARDED_RANKS, "gloo", SHARDED_PATHS, DIST_NTT_SIZES, 3),
            (1, "nccl", SHARDED_PATHS[:1], (), 3)):
        label = f"{world} rank{'s' if world > 1 else ''} {backend}"
        t0 = time.monotonic()
        ranks = run_ranks(sharded_rank, world, backend, "cuda",
                          args=(paths, ntt_sizes, reps, world > 1), timeout_s=SHARDED_TIMEOUT_S)
        group_s = time.monotonic() - t0
        print(f"sharded {label}: the group took {group_s:.1f} s (spawn, setup, checks and "
              f"proves)", flush=True)
        for r in ranks:
            for size, errs in r["ntt"].items():
                print(f"sharded {label} rank {r['rank']} distributed ntt/intt {size}: {errs}",
                      flush=True)
                require(errs["ntt_err"] == 0 and errs["intt_err"] == 0,
                        f"sharded {label} rank {r['rank']}: distributed transform {size} differs")
        per_path = {}
        for path_label, _, _, pin, required in paths:
            pin = pin or expected[path_label][0]
            rows = [r["paths"][path_label] for r in ranks]
            for r, row in zip(ranks, rows):
                got = proof_digest(row["bytes"])
                print(f"sharded {label} {path_label} rank {r['rank']} ({r['device']}): proof "
                      f"{got[0]} bytes sha256 {got[1]}; launches {row['launches']}; peak "
                      f"device memory {row['peak_bytes']} bytes; exchanges {row['traffic']}; "
                      f"prove_s {[round(t, 6) for t in row['prove_s']]}; FRI layers sharded "
                      f"{row['fri_sharded']}; kernels vs plain {row['kernel_errs']}",
                      flush=True)
                require(got == pin, f"sharded {label} {path_label} rank {r['rank']}: proof "
                        f"differs from its pin {pin}")
                check_launches(f"sharded {label} {path_label} rank {r['rank']}",
                               row["launches"], required)
                require(not any(row["plain_calls"].values()),
                        f"sharded {label} {path_label}: plain versions called {row['plain_calls']}")
                require(row["host_fallbacks"] == 0,
                        f"sharded {label} {path_label}: {row['host_fallbacks']} host fallbacks")
                ran = {op for op, (calls, _, _) in row["traffic"].items() if calls}
                require(ran == COLLECTIVES, f"sharded {label} {path_label} rank {r['rank']}: "
                        f"collectives called {sorted(ran)}, not {sorted(COLLECTIVES)}")
                for name, e in row["kernel_errs"].items():
                    results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)
                    require(e == 0, f"sharded {label} {path_label}: {name} != plain version "
                            f"at the shard shapes")
                for k, n in row["launches"].items():
                    launches[k] = launches.get(k, 0) + n
            stark, assertions = starks[path_label]
            verify_proof(stark, assertions, rows[0]["bytes"], None, f"sharded {label} {path_label}")
            best = max(min(row["prove_s"]) for row in rows)
            print(f"sharded {label} {path_label}: prove best-of-{len(rows[0]['prove_s'])} "
                  f"{best:.6f} s (the slowest rank's best) against {single[path_label]:.6f} s "
                  f"on one device in this call ({label}{', sharing one card' if world > 1 else ''}: "
                  f"no scaling number)", flush=True)
            per_path[path_label] = {
                "prove_s_best": best, "single_prove_s": single[path_label],
                "per_rank": [{"rank": r["rank"], "launches": row["launches"],
                              "peak_bytes": row["peak_bytes"], "prove_s": row["prove_s"],
                              "warmup_s": row["warmup_s"], "exchanges": row["traffic"]}
                             for r, row in zip(ranks, rows)]}
        entry = {"group_s": group_s, "paths": per_path}
        if world > 1:
            entry["ntt_scaling"] = ranks[0]["scaling"]
            bf = (2 ** 16) * 17 / single_ntt_s
            entry["comm_compute_split"] = comm_compute_split(2 ** 17, world, NVLINK_GBPS, bf)
            entry["comm_compute_split"]["inputs"] = (
                f"single-card p128 2^17 ntt {single_ntt_s:.6f} s in this call; NVLink "
                f"{NVLINK_GBPS} GB/s from the H100 SXM data sheet")
        record[label] = entry
    print(json.dumps({"sharded": record}), flush=True)
    return launches


def run_staged(kernels, stark, assertions, inputs, pin, required, label: str,
               sync_log: dict, smi_line: str, public=None, reps: int = 5):
    """One configuration through both provers: a warm-up of each; the
    launch counts set to 0, one `prove_staged`, the counts read, with every
    plain version's calls counted (there must be none); its bytes equal to
    `prove`'s and to the pin (where there is one), verified by the port;
    then `reps` turns of prove and prove_staged (best and median of each)
    and the synchronizing calls of one warm prove_staged.  Returns
    (launches, stats)."""
    import torch
    fused = stark.serialize(stark.prove(assertions, inputs))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    stark.prove_staged(assertions, inputs)
    torch.cuda.synchronize()
    warmup = time.monotonic() - t0
    kernels.reset_launch_counts()
    with plain_calls() as plain:
        data = stark.serialize(stark.prove_staged(assertions, inputs))
        torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    require_native(stark, label)
    got = proof_digest(data)
    print(f"{label} prove_staged proof: {got[0]} bytes sha256 {got[1]}; launches in one "
          f"prove_staged: {launches}; plain-version calls {plain or 0}", flush=True)
    require(not plain, f"{label}: prove_staged on the card ran plain versions {plain}")
    require(data == fused, f"{label}: prove_staged and prove gave different bytes")
    if pin is not None:
        require(got == pin, f"{label} staged proof differs from its pin {pin}")
    check_launches(f"{label} staged", launches, required)
    verify_proof(stark, assertions, data, public, f"{label} staged")
    times = {"prove": [], "prove_staged": []}
    for _ in range(reps):
        for name, fn in (("prove", stark.prove), ("prove_staged", stark.prove_staged)):
            t0 = time.monotonic()
            fn(assertions, inputs)
            torch.cuda.synchronize()
            times[name].append(time.monotonic() - t0)
    syncs = count_syncs(kernels, lambda: stark.prove_staged(assertions, inputs))
    sync_log[f"{label} staged"] = syncs
    stats = {k: {"best": min(v), "median": median(v), "all": [round(t, 6) for t in v]}
             for k, v in times.items()}
    print(f"{label}: prove_staged_s best of {reps} {stats['prove_staged']['best']:.6f}, median "
          f"{stats['prove_staged']['median']:.6f} (warm-up {warmup:.4f}); prove_s best of "
          f"{reps} {stats['prove']['best']:.6f}, median {stats['prove']['median']:.6f}; "
          f"on {smi_line}", flush=True)
    print(f"{label} staged synchronizing calls in one warm prove_staged: {syncs['syncs']} "
          f"({syncs['after_first_kernel']} after its first kernel); host wait "
          f"{fmt_ms(syncs['host_wait_ms'])}; sites {syncs['sites']}", flush=True)
    return launches, dict(stats, syncs=syncs["syncs"], bytes=got[0])


def plain_transform(dev, x, plan):
    """The public transform's plain path, on the tensors' device: the
    radix-2 route's `transform_ref`, or the digit route with every level
    run by `run_dft_level_ref` (in column chunks, `plain_level`)."""
    from genstark_tpu_torch import ntt
    from genstark_tpu_torch.ntt import dft, radix2
    if isinstance(plan, radix2.Radix2Plan):
        return radix2.transform_ref(dev, x, plan)
    saved = dft.run_dft_level
    dft.run_dft_level = plain_level
    try:
        return ntt._digit_transform(dev, x, plan)
    finally:
        dft.run_dft_level = saved


def check_ntt_rate(kernels, device, smi_line: str) -> dict:
    """The port's public `ntt` of 2^20 p128 points (four kernel-1 levels of
    32) against its plain path (tolerance 0), then its time on the card
    (CUDA events, mean of 10 after a warm-up) as butterflies a second,
    (n/2) log2(n) / t: the JAX package's NTT quantity (bench.py:114-168),
    printed beside the card, not a benchmark."""
    import torch
    from genstark_tpu_torch import ntt
    from genstark_tpu_torch.field import P128, create_prime_field
    field = create_prime_field(P128)
    dev = field.device_field(device)
    n = 2 ** 20
    x = device_elements(device, 2024, field.modulus, dev.L, n)
    kernels.reset_launch_counts()
    got = ntt.ntt(field, x)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launch_counts.items() if v}
    plan = ntt._plan(field, dev, n, False)
    err = max_abs_err(got, plain_transform(dev, x, plan))
    del got
    ms = cuda_ms(lambda: ntt.ntt(field, x), reps=10)
    rate = (n // 2) * (n.bit_length() - 1) / (ms / 1e3)
    out = {"n": n, "levels": list(plan.levels), "max_abs_err": err, "ms": ms,
           "butterflies_per_s": rate, "launches": launches, "device": smi_line}
    print(f"public ntt p128 n = {n} (levels {plan.levels}): max_abs_err={err}; {ms:.4f} ms, "
          f"{rate:.6e} butterflies/s on {smi_line}; launches {launches}", flush=True)
    require(err == 0, f"public ntt of {n} p128 points != its plain path")
    print(json.dumps({"ntt_2_20": out}), flush=True)
    return out


def check_public_ntt(kernels, device, rng, smi_line: str) -> None:
    """The public ntt / intt / low_degree_extend on the card at the staged
    paths' sizes (NTT_SIZES) against their plain path on the same card
    tensors, tolerance 0, and their round trips; kernel 5 and kernel 8 at
    the demo's field first (its p far below 2^32)."""
    import torch
    from genstark_tpu_torch import field as fields
    from genstark_tpu_torch import ntt
    from genstark_tpu_torch.field import create_prime_field
    demo = create_prime_field(DEMO_MODULUS)
    dev = demo.device_field(device)
    a = dev.from_numpy(random_elements(rng, DEMO_MODULUS, dev.L, 2 ** 15))
    b = dev.from_numpy(random_elements(rng, DEMO_MODULUS, dev.L, 2 ** 15))
    pm1 = dev.from_numpy(p_minus_1(demo, 2 ** 15))
    for op, ref in (("mul", dev.mont_mul_ref), ("add", dev.add_ref), ("sub", dev.sub_ref)):
        err = max(max_abs_err(kernels.field_ew(dev, op, x, y), ref(x, y))
                  for x, y in ((a, b), (a, b[:, :1]), (pm1, pm1)))
        print(f"field_ew p = {DEMO_MODULUS} L=2 {op} [2, 2^15]: max_abs_err={err}", flush=True)
        require(err == 0, f"field_ew at p = {DEMO_MODULUS} != plain version")
    for name, T, Ne in NTT_SIZES:
        modulus = getattr(fields, name) if isinstance(name, str) else name
        field = create_prime_field(modulus)
        dev = field.device_field(device)
        x = dev.from_numpy(random_elements(rng, modulus, dev.L, T))
        kernels.reset_launch_counts()
        coeffs = ntt.intt(field, x)
        evals = ntt.ntt(field, x)
        lde = ntt.low_degree_extend(field, coeffs, Ne)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launch_counts.items() if v}
        plan = lambda n, inverse: ntt._plan(field, dev, n, inverse)
        errs = {
            "intt": max_abs_err(coeffs, plain_transform(dev, x, plan(T, True))),
            "ntt": max_abs_err(evals, plain_transform(dev, x, plan(T, False))),
            "lde": max_abs_err(lde, plain_transform(
                dev, torch.nn.functional.pad(coeffs, (0, Ne - T)), plan(Ne, False))),
            "ntt(intt(x)) - x": max_abs_err(ntt.ntt(field, coeffs), x),
            "lde[::ext] - x": max_abs_err(lde[:, ::Ne // T].contiguous(), x),
            "intt(lde) - coeffs": max_abs_err(
                ntt.intt(field, lde), torch.nn.functional.pad(coeffs, (0, Ne - T))),
        }
        km = cuda_ms(lambda: ntt.low_degree_extend(field, ntt.intt(field, x), Ne))
        pm = cuda_ms(lambda: plain_transform(dev, torch.nn.functional.pad(
            plain_transform(dev, x, plan(T, True)), (0, Ne - T)), plan(Ne, False)), reps=2)
        print(f"public ntt p{modulus.bit_length()} (L={dev.L}, {type(plan(T, True)).__name__}) "
              f"T={T} Ne={Ne}: max_abs_err {errs}; launches {launches}; intt + LDE "
              f"{km:.4f} ms, plain path {pm:.4f} ms on {smi_line}", flush=True)
        require(not any(errs.values()), f"public ntt at p{modulus.bit_length()}: {errs}")
        del x, coeffs, evals, lde
    torch.cuda.empty_cache()


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "genstark_tpu_torch")):
        raise SmokeFailure("genstark_tpu_torch is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this test needs a CUDA card")

    phase("device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)
    device = torch.device("cuda", 0)

    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.field import P32, P64, P128, P224, P256, create_prime_field
    from genstark_tpu_torch.ntt import DftPlan, dft_levels
    from genstark_tpu_torch.testing import GOLDILOCKS, SOLINAS96, SOLINAS160, SOLINAS192
    sys.path.insert(0, os.path.join(HERE, "examples"))
    from mimc_torch import make_mimc_stark, prove_div, prove_mimc, round_constants
    from examples import (demo_static_torch, elliptic_torch, fibonacci_torch,
                          merkle_import_torch, poseidon_torch, rescue_torch)

    phase("build")
    t0 = time.monotonic()
    kernels.build()
    print(f"kernel build {time.monotonic() - t0:.1f} s", flush=True)
    reports = ptxas_report(kernels.build_info["log"])
    for name, report in reports:
        print(f"ptxas: {name}: {report}", flush=True)
    # the butterflies, kernel 5 and kernel 10 on the word product: a spill
    # there is a fault (K words need fewer registers than the 2L + 1
    # accumulators of a 16-bit-limb product); so is one in kernel 1, whose
    # A fragments must stay in registers at every L
    for part in word_kernels():
        found = [report for name, report in reports if part in name]
        require(found, f"{part} is not in the build's register report")
        require(all(r.endswith((", 0 bytes spilled", ", no spills")) for r in found),
                f"{part} spills registers: {found}")
    # kernel 3's blake2s over 64-byte p128 leaves (L = 8, two vectors): one
    # compression, against the 1,120 u32 ops the bound counts a block
    sass = sass_report(kernels.build(), "digest_limbs_kernelILi1ELi8ELi2ELb0E")
    if sass is None:
        print("sass: digest_limbs_kernel<blake2s, L = 8, V = 2>: not measured", flush=True)
    else:
        alu = {op: sass.get(op, 0) for op in ("IADD3", "LOP3", "SHF", "PRMT", "IMAD", "LEA")}
        print(f"sass: digest_limbs_kernel<blake2s, L = 8, V = 2>: {sum(sass.values())} "
              f"instructions; {alu}: {sum(alu.values())} integer ALU instructions against "
              f"{BLAKE2S_BLOCK_OPS} u32 ops the bound counts a block; all opcodes {sass}",
              flush=True)

    phase("kernels vs plain versions (exact, tolerance 0)")
    src, tpu = "genstark_tpu_torch/csrc/", "genstark_tpu/"
    meta = {   # name: (source, the TPU kernel it replaces), in the order of the table rows
        "dft_level": (src + "dft_level.cu", tpu + "ntt/mxu.py:356"),
        "hash_words": (src + "hash.cu", tpu + "hash/pallas_hash.py:182"),
        "hash_limbs": (src + "hash.cu", tpu + "hash/pallas_hash.py:200"),
        "lcomb_tail": (src + "lcomb_tail.cu", tpu + "protocol/lincomb_kernel.py:47"),
        "field_ew": (src + "field_ops.cu", tpu + "field/pallas_ops.py:34"),
        "outer_table": (src + "field_ops.cu", tpu + "field/pallas_ops.py:79"),
        "bfly_stage": (src + "butterfly_stage.cu", tpu + "ntt/pallas_kernels.py:120"),
        "butterfly": (src + "butterfly.cu", tpu + "ntt/pallas_kernels.py:204"),
        "bfly_stage_split": (src + "butterfly_stage.cu", tpu + "ntt/pallas_kernels.py:308"),
        "mont_chain": (src + "probes.cu", "scripts/roofline.py:78"),
        "u32_chain": (src + "probes.cu", "scripts/vpu_bound.py:24"),
        # the port's kernels without a Pallas row: the JAX functions they
        # replace run in XLA
        "mont_inv": (src + "field_ops.cu", tpu + "field/device.py:325"),
        "sample_queries": (src + "queries.cu", tpu + "protocol/device_queries.py:53"),
    }
    results = {k: {"max_abs_err": 0, "ms": None, "plain_ms": None} for k in meta}
    rng = np.random.default_rng(2024)
    f128, f32 = create_prime_field(P128), create_prime_field(P32)
    dev128, dev32 = f128.device_field(device), f32.device_field(device)
    check_dft(dev128, f128, rng, results)
    check_dft(dev32, f32, rng, results)
    wide_digit = [create_prime_field(m)
                  for m in (GOLDILOCKS, SOLINAS96, SOLINAS160, SOLINAS192, P224, P256)]
    for field in wide_digit:          # kernel 1 at L = 4, 6, 10, 12, 14 and 16
        check_dft(field.device_field(device), field, rng, results)
    check_hash_words(dev128, rng, results)
    check_hash_limbs(dev128, f128, rng, results)
    check_tail(dev128, f128, rng, results)
    # every limb count: L = 2, 4, 8, 6, 10, 12, 14, 16 (P256 last)
    all_fields = [create_prime_field(m) for m in (P32, P64, P128, SOLINAS96, SOLINAS160,
                                                  SOLINAS192, P224, P256)]
    f64, f96, f160, f192, f256 = (all_fields[i] for i in (1, 3, 4, 5, -1))
    dev256 = f256.device_field(device)
    check_field_ew(device, all_fields, rng, results)
    check_outer(device, all_fields, rng, results)
    check_butterfly(device, all_fields, rng, results)
    check_hash_limbs(dev256, f256, rng, results, record_times=False)
    for field in all_fields:          # every instantiation of the word product's kernel 4
        if field is not f128:
            check_tail(field.device_field(device), field, rng, results, record_times=False)
    check_stages(device, all_fields, rng, results)
    check_butterfly_bitrev(device, all_fields, rng, results)
    check_demo_field(device, rng, results)
    check_hash_limbs_forms(device, all_fields, results)
    check_merkle_shapes(device, rng, results)
    check_probes(device, all_fields, rng, results)
    check_mont_inv(kernels, device, all_fields, rng, results)
    check_sample_queries(kernels, device, rng, results)
    torch.cuda.synchronize()

    phase("DeviceField.inv on the card against inv_ref (kernel 5)")
    check_inv(kernels, device, all_fields, rng)

    phase("probes: the card's Montgomery-multiply and u32 op rates")
    rates = measure_rates(kernels, device, all_fields)

    phase("kernels 1, 3, 4 and 6: device time at the main paths' shapes (torch.profiler)")
    print(json.dumps({"kernel_times": kernel_times(device, rates)}), flush=True)

    phase(f"large transforms: P256 at {LARGE_N} points by three radix-2 routes, 2x and 4x "
          f"round trips")
    check_large_transforms(kernels, device, f256, rng)

    phase(f"the P256 LDEs of {LARGE_N} and {4 * LARGE_N} points on the digit route and on the "
          f"radix-2 route, in this one call")
    route_times = check_route_times(kernels, device, f256, (LARGE_N, 4 * LARGE_N), smi_line)

    phase(f"the {LARGE_N}-point LDE over the 192-bit solinas field (L = 12) on the digit route "
          f"and on the radix-2 route")
    route_times["p192"] = check_route_times(kernels, device, f192, (LARGE_N,), smi_line)

    phase("kernel 1 at every level of a 2^20-point LDE (R^-1) over 2^64 - 2^32 + 1, the "
          "solinas moduli of 96, 160 and 192 bits, and P224")
    for field in wide_digit[:5]:
        n = 2 ** 20
        check_dft_chain(device, field, DftPlan(
            field, field.device_field(device), n, field.get_root_of_unity(n),
            field.inv(field.params.R_mod % field.modulus)),
            f"p{field.modulus.bit_length()} LDE 2^20 (R^-1)", results)

    phase(f"kernels vs plain versions at the {LARGEST_STEPS}-step path's largest shapes "
          f"(Ne = {4 * LARGE_N}, [2, 16, Ne] operands; kernel 1 at every level of the LDE and "
          f"the iNTT of the {LARGE_STEPS}- and {LARGEST_STEPS}-step paths)")
    t0 = time.monotonic()
    mimc256_times = check_largest_shapes(device, f256, 4 * LARGE_N, results, rates,
                                         ladder_plans(f256, dev256, (LARGE_STEPS, LARGEST_STEPS)))
    print(json.dumps({"mimc256_kernel_times": {
        k: {"ms": v[0], "device_ms": v[1], "bound_ms": v[2], "bound_by": v[3]}
        for k, v in mimc256_times.items()}, "device": smi_line}), flush=True)
    print(f"largest-shape checks {time.monotonic() - t0:.1f} s", flush=True)

    phase(f"kernels vs plain versions at the mimc64-2^18 path's shapes (P64, Ne = {LARGE_N}, "
          f"[2, 4, Ne] operands: kernel 8's bit-reversed pass and the stage passes)")
    t0 = time.monotonic()
    check_largest_shapes(device, f64, LARGE_N, results)
    print(f"mimc64 shape checks {time.monotonic() - t0:.1f} s", flush=True)

    for field in (f96, f160, f192):
        L, bits = field.params.L, field.modulus.bit_length()
        phase(f"kernels vs plain versions at the mimc{bits}-2^18 path's shapes (L = {L}, Ne = "
              f"{LARGE_N}, [2, {L}, Ne] operands; kernel 1 at every level of its LDE and iNTT, "
              f"kernel 8's bit-reversed pass and the stage passes of the radix-2 route"
              f"{'; timed' if field is f192 else ''})")
        t0 = time.monotonic()
        mid_times = check_largest_shapes(device, field, LARGE_N, results,
                                         rates if field is f192 else None,
                                         ladder_plans(field, field.device_field(device),
                                                      (LARGE_STEPS,)), radix2_too=True)
        print(f"mimc{bits} shape checks {time.monotonic() - t0:.1f} s", flush=True)
    print(json.dumps({"mimc192_kernel_times": {
        k: {"ms": v[0], "device_ms": v[1], "bound_ms": v[2], "bound_by": v[3]}
        for k, v in mid_times.items()}, "device": smi_line}), flush=True)

    phase(f"kernels vs plain versions at the MiMC-128 ladder's largest shapes (Ne = "
          f"{16 * LADDER_STEPS[-1]}, [2, 8, Ne] operands; kernel 1 at every level of the "
          f"LDE and the iNTT of the {LADDER_STEPS[1]}- and {LADDER_STEPS[2]}-step paths)")
    t0 = time.monotonic()
    ladder_times = check_largest_shapes(device, f128, 16 * LADDER_STEPS[-1], results, rates,
                                        ladder_plans(f128, dev128))
    print(json.dumps({"ladder_kernel_times": {
        k: {"ms": v[0], "device_ms": v[1], "bound_ms": v[2], "bound_by": v[3]}
        for k, v in ladder_times.items()}, "device": smi_line}), flush=True)
    print(f"ladder largest-shape checks {time.monotonic() - t0:.1f} s", flush=True)

    phase("pinned toy proofs on the card, each verified by the port")
    toy_assertions = lambda stark, count: mimc_assertions(
        stark, round_constants(stark.air.field, count), 64)
    for modulus, count, pin in ((P32, 16, P32_PIN), (P128, 32, P128_PIN)):
        stark, constants = make_mimc_stark(64, device, modulus=modulus, use_input=False,
                                           constant_count=count, options=TOY)
        assertions = toy_assertions(stark, count)
        data = stark.serialize(stark.prove(assertions, [], [3]))
        require_native(stark, "toy")
        got = proof_digest(data)
        print(f"p{modulus.bit_length()} pin: {got[0]} bytes sha256 {got[1]}", flush=True)
        require(got == pin, f"p{modulus.bit_length()} proof differs from its pin {pin}")
        verify_proof(stark, assertions, data, None, f"p{modulus.bit_length()} pin")
    kernels.reset_launch_counts()
    div_stark, data = prove_div(64, device)
    div_launches = dict(kernels.launch_counts)
    div_products = div_launches["field_ew"]
    check_launches("division AIR", div_launches, DIV_KERNELS)
    require_native(div_stark, "division AIR")
    div_assertions = toy_assertions(div_stark, 16)
    verify_proof(div_stark, div_assertions, data, None, "division AIR")
    sync_log = {}
    check_one_fetch(kernels, div_stark, lambda: div_stark.prove(div_assertions, [], [3]),
                    "division AIR", sync_log)
    kernels.reset_launch_counts()
    _, plain = prove_mimc(64, device, modulus=P128, use_input=False, constant_count=16,
                          options=TOY)
    got = proof_digest(data)
    print(f"division AIR pin: {got[0]} bytes sha256 {got[1]}; kernel-5 launches {div_products} "
          f"(plain MiMC over the same constants {kernels.launch_counts['field_ew']})", flush=True)
    require(got == DIV_PIN, f"division AIR proof differs from its pin {DIV_PIN}")
    require(plain == data, "division AIR proof != plain MiMC's over the same constants")
    require(div_products > kernels.launch_counts["field_ew"],
            "the division AIR's prove launched no more products than plain MiMC's")
    for label, modulus, options, pin, required in (
            ("p256", P256, None, P256_64_PIN, ("dft_level",)),
            ("p64", P64, TOY, P64_64_PIN, ("butterfly",)),
            ("goldilocks", GOLDILOCKS, TOY, GOLDILOCKS_64_PIN, ("dft_level",)),
            ("p96", SOLINAS96, TOY, SOLINAS96_64_PIN, ("dft_level",)),
            ("p160", SOLINAS160, TOY, SOLINAS160_64_PIN, ("dft_level",)),
            ("p192", SOLINAS192, TOY, SOLINAS192_64_PIN, ("dft_level",))):
        kernels.reset_launch_counts()
        stark, data = prove_mimc(64, device, modulus=modulus, options=options)
        launches = dict(kernels.launch_counts)
        require_native(stark, "toy")
        got = proof_digest(data)
        print(f"{label} secret-input pin: {got[0]} bytes sha256 {got[1]}; transform launches "
              f"{ {k: launches[k] for k in ('dft_level',) + RADIX2_KERNELS} }", flush=True)
        require(got == pin, f"{label} proof differs from its pin {pin}")
        check_launches(f"{label} toy", launches, required)
        verify_proof(stark, toy_assertions(stark, 64), data, None, f"{label} secret-input pin")

    def mimc_path(steps, modulus=P128):
        stark, constants = make_mimc_stark(steps, device, modulus=modulus)
        return stark, mimc_assertions(stark, constants, steps), [[3]]

    phase(f"bench config: MiMC-128, {BENCH_STEPS} steps, secret input 3")
    bench_launches, _, bench_totals = run_main_path(
        kernels, *mimc_path(BENCH_STEPS), BENCH_PIN, BENCH_KERNELS, "bench", sync_log)

    phase(f"MiMC-256: P256, {BENCH_STEPS} steps, secret input 3 (the digit route, L = 16)")
    digit256 = {"mimc256": {}, "mimc256-2^18": {}}
    mimc256_launches, _, mimc256_totals = run_main_path(
        kernels, *mimc_path(BENCH_STEPS, P256), MIMC256_PIN, BENCH_KERNELS, "mimc256",
        sync_log, stats=digit256["mimc256"])

    phase("the reference's Merkle-proof configurations (compiled from AirScript) and "
          "point multiplication (AirAssembly)")
    merkle_launches = []
    for label, case, pin, required in (
            ("rescue-merkle-16", lambda: rescue_torch.branch_case(16, 42, None, device),
             RESCUE16_PIN, MERKLE_KERNELS),
            ("poseidon-merkle-16", lambda: poseidon_torch.branch_case(16, 42, None, device),
             POSEIDON16_PIN, MERKLE_KERNELS),
            ("lib224-merkle-8", lambda: merkle_import_torch.merkle_proof_case(
                8, 42, None, device), LIB224_PIN, MERKLE_KERNELS),
            ("pointmul", lambda: elliptic_torch.pointmul_case(None, device) + (None,),
             POINTMUL_PIN, MERKLE_KERNELS)):
        stark, assertions, inputs, public = case()
        print(f"{label}: {stark.air.trace_register_count} registers, "
              f"{stark.air.secret_input_count} secret inputs, "
              f"{assertions[0].step + 1} steps, ext {stark.air.extension_factor}", flush=True)
        launches_, _, _ = run_main_path(kernels, stark, assertions, inputs, pin, required,
                                        label, sync_log, public=public)
        merkle_launches.append(launches_)

    phase(f"the reference's demos on the one-fetch path: fibonacci ({FIB_STEPS} steps, p32) "
          f"and static variables ({DEMO_STEPS} steps, p = {DEMO_MODULUS})")
    fib_field = create_prime_field(P32)
    fib_last = fibonacci_torch.run_fibonacci(fib_field, FIB_STEPS, 1)[-1][1]
    demo_last = demo_static_torch.run_demo(create_prime_field(DEMO_MODULUS), DEMO_STEPS, 1)[-1]
    print(f"oracles: fibonacci {fib_last} (reference {fibonacci_torch.EXPECTED[FIB_STEPS]}), "
          f"static variables {demo_last} (reference {demo_static_torch.EXPECTED_RESULT})",
          flush=True)
    require(fib_last == fibonacci_torch.EXPECTED[FIB_STEPS], "fibonacci oracle != reference")
    require(demo_last == demo_static_torch.EXPECTED_RESULT, "static-variables oracle != reference")
    demo_cases = {
        "fibonacci": lambda: fibonacci_torch.fib_case(FIB_STEPS, device=device) + (None,),
        "demo-static": lambda: demo_static_torch.demo_case(DEMO_STEPS, device=device) + (None,)}
    demo_launches = []
    for label, pin, required in (("fibonacci", FIB_PIN, FIB_KERNELS),
                                 ("demo-static", DEMO_PIN, DEMO_KERNELS)):
        stark, assertions, inputs, _ = demo_cases[label]()
        launches_, _, _ = run_main_path(kernels, stark, assertions, inputs, pin, required,
                                        label, sync_log)
        demo_launches.append(launches_)

    phase("the staged prover: prove_staged against prove, bytes, pins, plain-version calls, "
          "syncs and launches")
    staged = {}
    for label, case, pin, required in (
            ("bench", lambda: mimc_path(BENCH_STEPS) + (None,), BENCH_PIN, STAGED_DIGIT),
            ("mimc256", lambda: mimc_path(BENCH_STEPS, P256) + (None,), MIMC256_PIN,
             STAGED_DIGIT),
            ("rescue-merkle-16", lambda: rescue_torch.branch_case(16, 42, None, device),
             RESCUE16_PIN, STAGED_DIGIT),
            ("fibonacci", demo_cases["fibonacci"], FIB_PIN, STAGED_DIGIT),
            ("demo-static", demo_cases["demo-static"], DEMO_PIN, STAGED_RADIX2)):
        stark, assertions, inputs, public = case()
        launches_, stats = run_staged(kernels, stark, assertions, inputs, pin, required, label,
                                      sync_log, smi_line, public=public)
        staged[label] = dict(stats, launches=launches_)
        del stark
    torch.cuda.empty_cache()
    print(json.dumps({"staged": staged, "device": smi_line}), flush=True)

    phase("the public ntt / intt / low_degree_extend at the staged paths' sizes against the "
          "plain path (tolerance 0)")
    check_public_ntt(kernels, device, rng, smi_line)

    phase(f"MiMC-256: P256, {LARGE_STEPS} steps (Ne = {16 * LARGE_STEPS}: the digit route, "
          f"levels {dft_levels(16 * LARGE_STEPS)})")
    large_launches, large_data, large_totals = run_main_path(
        kernels, *mimc_path(LARGE_STEPS, P256), LARGE_PIN, BENCH_KERNELS, "mimc256-2^18",
        sync_log, stats=digit256["mimc256-2^18"])
    del large_data
    torch.cuda.empty_cache()
    print(json.dumps({"path_kernel_totals": {
        label: {short: [us / 1e3, n] for short, (us, n) in totals.items()
                if short in ("digest_limbs_kernel", "outer_table_kernel")}
        for label, totals in (("bench", bench_totals), ("mimc256", mimc256_totals),
                              ("mimc256-2^18", large_totals))}}), flush=True)

    phase(f"MiMC over P64, {LARGE_STEPS} steps (Ne = {16 * LARGE_STEPS}: the direct radix-2 "
          f"route), one-fetch, staged and four-step")
    stark, assertions, inputs = mimc_path(LARGE_STEPS, P64)
    mimc64_launches, mimc64_data, _ = run_main_path(
        kernels, stark, assertions, inputs, MIMC64_18_PIN, RADIX2_LARGE_KERNELS, "mimc64-2^18",
        sync_log)
    mimc64_staged, stats = run_staged(
        kernels, stark, assertions, inputs, MIMC64_18_PIN, STAGED_RADIX2, "mimc64-2^18",
        sync_log, smi_line, reps=3)
    print(json.dumps({"mimc64-2^18 staged": stats, "device": smi_line}), flush=True)
    del stark
    four = four_step_proof(device, LARGE_STEPS, P64)
    print(f"mimc64-2^18 through the four-step route: {proof_digest(four)}", flush=True)
    require(four == mimc64_data, "mimc64-2^18: the direct and four-step routes disagree")
    del four, mimc64_data
    torch.cuda.empty_cache()

    mid_paths, mid_launches = run_mid_limb_paths(kernels, device, sync_log, smi_line)
    print(json.dumps({"mid_limb_paths": mid_paths, "device": smi_line}), flush=True)

    phase("the public ntt of 2^20 p128 points: its rate on the card")
    check_ntt_rate(kernels, device, smi_line)

    ladder, ladder_launches = {}, []

    def ladder_path(steps, pin=None):
        label = f"mimc128-2^{steps.bit_length() - 1}"
        phase(f"MiMC-128 ladder: {steps} steps (Ne = {16 * steps}, the LDE's levels "
              f"{dft_levels(16 * steps)})")
        t0 = time.monotonic()
        stark, assertions, _ = mimc_path(steps)
        launches_, data, ladder[label] = run_largest(kernels, stark, assertions, BENCH_KERNELS,
                                                      label, sync_log, pin=pin)
        ladder_launches.append(launches_)
        print(f"{label} phase {time.monotonic() - t0:.1f} s", flush=True)
        return label, stark, assertions, data

    label, stark, _, _ = ladder_path(LADDER_STEPS[0], LADDER_17_PIN)
    del stark
    torch.cuda.empty_cache()
    label, stark, assertions, data = ladder_path(LADDER_STEPS[1])
    north_star = proof_digest(data)
    t0 = time.monotonic()
    launches_, ladder[label]["staged"] = run_staged(
        kernels, stark, assertions, [[3]], north_star, STAGED_DIGIT, label, sync_log, smi_line,
        reps=2)
    ladder_launches.append(launches_)
    print(f"{label} staged phase {time.monotonic() - t0:.1f} s", flush=True)

    phase(f"sharded prover: {SHARDED_RANKS} ranks sharing one card over gloo (the bench, "
          f"MiMC-256 at {LARGE_STEPS} steps and MiMC-128 at {LADDER_STEPS[1]} steps, "
          f"distributed NTT at {DIST_NTT_SIZES}), then one rank over nccl (the bench)")
    t0 = time.monotonic()
    sharded_launches = run_sharded(
        device, results, smi_line,
        {label: (north_star, ladder[label]["best_s"], stark, assertions)})
    print(f"sharded phases {time.monotonic() - t0:.1f} s", flush=True)
    del stark, data
    torch.cuda.empty_cache()

    phase(f"MiMC-256: P256, {LARGEST_STEPS} steps (Ne = {16 * LARGEST_STEPS}: the digit "
          f"route, levels {dft_levels(16 * LARGEST_STEPS)})")
    stark, assertions, _ = mimc_path(LARGEST_STEPS, P256)
    largest_launches, _, digit256["mimc256-2^20"] = run_largest(
        kernels, stark, assertions, BENCH_KERNELS, "mimc256-2^20", sync_log)
    del stark
    torch.cuda.empty_cache()
    print(json.dumps({"mimc256_digit_route": {
        label: {k: v.get(k) for k in ("best_s", "median_s", "busy_pct", "device_ms",
                                       "profiled_wall_ms", "peak_bytes", "port_kernels_ms")}
        for label, v in digit256.items()}, "routes": route_times, "device": smi_line}),
        flush=True)

    _, stark, _, _ = ladder_path(LADDER_STEPS[2])
    del stark
    torch.cuda.empty_cache()
    print(json.dumps({"ladder": ladder, "device": smi_line}), flush=True)
    print(json.dumps({"syncs": sync_log}), flush=True)

    from genstark_tpu_torch.native import tracegen
    print(f"g++ builds of the native trace generators: {len(tracegen.build_seconds)}, "
          f"{sum(tracegen.build_seconds.values()):.3f} s in all "
          f"({ {k: round(v, 3) for k, v in tracegen.build_seconds.items()} })", flush=True)
    launches = {k: bench_launches[k] + mimc256_launches[k] + large_launches[k]
                + largest_launches[k] + mimc64_launches[k] + mimc64_staged[k]
                + sum(m[k] for m in merkle_launches)
                + sum(m[k] for m in ladder_launches)
                + sum(m[k] for m in mid_launches)
                + sum(m[k] for m in demo_launches)
                + sum(st["launches"][k] for st in staged.values())
                + div_launches[k] + rates["launches"].get(k, 0)
                + sharded_launches.get(k, 0) for k in meta}
    line = []
    for name in meta:
        r = results[name]
        bound_ms, bound_by, own_ms = bound(r, rates)
        floor_ms = 1e3 * r["chain"] * rates["u32_latency_s"] if "chain" in r else None
        line.append({"name": name, "route": "cuda", "source": meta[name][0],
                     "replaces": meta[name][1], "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "device_ms": r.get("device_ms"), "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None, "latency_floor_ms": floor_ms})
        own = "" if own_ms is None else f"; its Montgomery products at this code's rate {own_ms:.4f} ms"
        dms = r.get("device_ms")
        reached = "" if dms is None else f", device {dms:.4f} ms: {100 * bound_ms / dms:.1f}%"
        if floor_ms is not None:
            reached += (f"; latency floor {floor_ms:.6f} ms ({r['chain']} dependent ops)"
                        + ("" if dms is None else f": {100 * floor_ms / dms:.1f}% of device"))
        print(f"{name}: {r['ms']:.4f} ms against a bound of {bound_ms:.4f} ms "
              f"({bound_by}; {100 * bound_ms / r['ms']:.1f}% of it by events{reached}{own}), plain "
              f"{r['plain_ms']:.4f} ms, {launches[name]} launches on the paths", flush=True)
    kernels_line = {"kernels": line}
    print(json.dumps(kernels_line), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as err:
        print(f"chip_smoke FAILED: {err}", file=sys.stderr, flush=True)
        sys.exit(1)
