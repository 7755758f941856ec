"""What the port's checks share: chip_smoke.py (the card's runner), the
tests and the scripts take their pins, inputs and instruments from here.

- Proof pins: (bytes, sha256) of the proofs the port must give, with the
  step counts and options they are made at.  Each names where it comes
  from and which `slow` test remakes it.
- Edge inputs, which hold a field kernel to its plain version where its
  word chains are most likely to break: the values at which the last carry
  or borrow of a chain decides (`edge_values`), planted where a kernel's
  first butterflies add and subtract them as a pair (`edge_input`).
- Instruments: the port kernels' device time (`device_ms`, `profile_run`),
  a call's synchronizing calls (`count_syncs`), operand sets taken in turn
  (`in_turn`), the plain DFT level in column chunks (`plain_level`), the
  build's register report (`ptxas_report`, `word_kernels`) and the host
  sampler's work (`candidates_needed`, `odd_hex_roots`).

Importing this module needs Python alone: numpy, torch and the port's
package are imported inside the functions that use them, so
`scripts/torch_ew_dram.py` can load this file by path and measure another
tree of the repository with this tree's instruments.
"""

from __future__ import annotations

import os
import time

# 2^64 - 2^32 + 1 (Plonky2's "Goldilocks" prime): of solinas form (u = 1, a
# = 2), so the digit route takes it at L = 4, where P64 takes the radix-2
# route.  No example of the reference runs over it; the checks of kernel 1
# at L = 4 and chip_smoke.py's toy prove do.
GOLDILOCKS = 2 ** 64 - 2 ** 32 + 1

# The smallest u of p = 2^(32k) - u 2^32 + 1 that is prime, at 96, 160 and
# 192 bits: solinas moduli (u < 2^16, a = 2) whose field L (6, 10, 12)
# equals the spec's, so the digit route takes them; each has 2-adicity 32.
SOLINAS96 = 2 ** 96 - 2 ** 32 + 1
SOLINAS160 = 2 ** 160 - 21 * 2 ** 32 + 1
SOLINAS192 = 2 ** 192 - 49 * 2 ** 32 + 1
# Primes of the same form at 80, 144 and 176 bits (field L = 6, 10, 12):
# their byte count is 2 mod 4, so `solinas_spec` counts one limb fewer than
# the field and they take the radix-2 route (`ntt.digit_dft_field`).
SPLIT80 = 2 ** 80 - 111 * 2 ** 32 + 1
SPLIT144 = 2 ** 144 - 99 * 2 ** 32 + 1
SPLIT176 = 2 ** 176 - 373 * 2 ** 32 + 1

# Proof pins: (bytes, sha256).  The toy options: ext 4, 8/6 queries.
TOY = {"extension_factor": 4, "exe_query_count": 8, "fri_query_count": 6}
# MiMC, 64 steps, seed 3, the toy options: over P32 with 16 constants (the
# JAX package's tests/test_compat_vectors.py golden proof) and over P128
# with 32 (its tests/test_mxu_prover.py proof).
P32_PIN = (3472, "db79f92dcacf2cf2d1eeb7cee8db4a4eeb1e5bc5f4d13e9b0cdaacab7cc95b75")
P128_PIN = (7329, "3fa3bc9f84d3505912258df9974587b18b35619116a2787786b3beacd3cc4917")
# MiMC over P128, 64 steps, 16 constants, the toy options, a secret input
# register: the statements of inputs 3 and then 5, proved in a row on one
# JAX Stark (tests/test_torch_static_columns.py and
# tests/test_torch_prover_cache.py hold the port to them; their slow tests
# remake them).
MIMC128_INPUT_3_5_PINS = [
    (7398, "a405f2588f439445d45d0cd61c3b91c722bb21e2fa3e14ffd1bfd9559cbba00a"),
    (7077, "fcb65c1346e8971c93b3d694a1ea421bfbb9bca9de9947400595a7b9a46c1f9c")]
# MiMC-128, 2^13 steps, blake2s256, ext 16, 48/24 queries, secret input 3:
# the JAX package's proof on the CPU (tests/test_torch_prover.py's slow test
# remakes it).
BENCH_STEPS = 2 ** 13
BENCH_PIN = (97254, "3143467fcd3034ebdc758ce12b9501aa4b5f1c7efa57d5df8beaf153403fd928")
# MiMC over P256 = 2^256 - 351*2^32 + 1 (the reference's mimc256), 64 steps,
# 64 constants, secret input 3: the bench options, and the toy options over
# P64 (tests/test_torch_prover_fields.py's slow tests remake them).
P256_64_PIN = (40300, "aeca982219743b04f13dd8b6be2b855f951bb16fd4c837f841d62af059265be4")
P64_64_PIN = (4614, "8f2cc12a4eea675682570374637c919519eb1c5628201c0d5b99a9a5892f6fe9")
# MiMC over 2^64 - 2^32 + 1 (GOLDILOCKS, the digit route at L = 4), 64
# steps, 64 constants, the toy options with blake2s256, secret input 3: the
# JAX package's proof on the CPU (tests/test_torch_digit_wide.py holds the
# port to it; its slow test remakes it).
GOLDILOCKS_64_PIN = (5094, "90fc6d5ed4e181f7164c64d1cfc3c79bb7c377a25e512823e1a6d79bc5ec4b74")
# The same toy proof over the solinas moduli of 96, 160 and 192 bits
# (SOLINAS96 / 160 / 192: the digit route at L = 6, 10 and 12): the JAX
# package's proofs on the CPU (tests/test_torch_mid_limbs.py holds the port
# to them; its slow test remakes them).
SOLINAS96_64_PIN = (6101, "2ab4b85fdfbb65d0860ca092931d6551945551ac0a6b61e7b588d1172e746676")
SOLINAS160_64_PIN = (8582, "53b22224ff9817c671d7ce40852df4e1faa91cec951a5fe00314197c4f76a4b2")
SOLINAS192_64_PIN = (9638, "47211d573e672cf92074c65644983ea1754c9ba1291645b484365b91e51501f9")
# The division AIR (examples/mimc_torch.make_div_stark: a constraint that
# divides by a register), P128, 64 steps, the toy options, seed 3: the JAX
# package's proof on the CPU (tests/test_torch_inv.py holds the port to it;
# its slow test remakes it); equal to plain MiMC's over the same 16
# constants, since the quotient is nxt(0).
DIV_PIN = (7120, "79478399421030511fab75c58263cbd4a74f3e0a19f2bd3eab362460f5b598f5")
# MiMC-256, 2^13 steps, the bench options, secret input 3: the JAX package's
# proof on the CPU (tests/test_torch_prover_fields.py's slow test remakes it).
MIMC256_PIN = (118019, "da7b087ffccb38cf15a6bafd33a0905c30dddd81881229018dc3f6a3f6b97236")
# MiMC-256 at 2^18 steps (T = 2^18, Nc = 2^20, Ne = 2^22: every LDE to Ne on
# the direct route), the bench options, secret input 3: the port's proof
# from its plain versions on the CPU (`python -m examples.mimc_torch 262144 cpu
# P256`, which prints its time and peak host memory).
LARGE_STEPS = 2 ** 18
LARGE_PIN = (197428, "77ac03bf41603b6dc55ee72ec00680901a5d0d8929cf792f2b7a61268ca8ad2f")
# MiMC over P64 (not of solinas form: the radix-2 route, where the JAX
# package also runs its radix-2 kernels) at 2^18 steps, the bench options,
# secret input 3 (Ne = 2^22, the direct route's stage kernels 7/9 and kernel
# 8): the port's proof from its plain versions on the CPU (`python -m
# examples.mimc_torch 262144 cpu P64`; tests/test_torch_digit_wide.py's slow
# test remakes it).
MIMC64_18_PIN = (148598, "3dfb7dbd57b47a767d57ba35cb708fce4f969ec2d8a30ebce0e9a6e43ad0ed07")
# MiMC over the 192-bit solinas modulus 2^192 - 49 * 2^32 + 1 (the digit
# route at L = 12) at 2^18 steps, the bench options, secret input 3: the
# port's proof from its plain versions on the CPU (`python -m
# examples.mimc_torch 262144 cpu '2^192 - 49*2^32 + 1'`: 1,077 s and 16.9 GiB
# peak RSS on 8 CPU cores; tests/test_torch_mid_limbs.py's slow test
# remakes it).
MIMC192_18_PIN = (181813, "72bd9bad6311b708bd92dff965bab9af9a4c1c4e6351ae6bb9ec187f03cf5dd8")
# MiMC-128 (the bench's AIR, options and secret input) at 2^17 steps (Ne =
# 2^21, the digit route): the port's proof from its plain versions on the
# CPU (`python -m examples.mimc_torch 131072 cpu`, which prints its time and
# peak host memory; tests/test_torch_ladder.py's slow test remakes it).
LADDER_17_PIN = (147726, "196baca816715b912220583b99f484afade3b63745aaf6ee213369f06f02b5d5")
# The reference's Merkle-proof benchmark rows (its README; examples/rescue.py
# and examples/poseidon.py options), depth 16, index 42, compiled from their
# AirScript sources: Rescue (8 registers, 2^9 steps, p128, ext 16, 60/24
# queries) and Poseidon (12 registers, 2^10 steps, p128, ext 32, 44/20),
# the branch drawn from the prng (`branch_case`); and the lib224-import
# Merkle proof (examples/merkle_import_torch.py, 6 registers, p224, depth 8,
# index 42).  The port's proofs from its plain versions on the CPU
# (tests/test_torch_script.py's slow tests remake them and hold them equal
# to the JAX package's).
RESCUE16_PIN = (73999, "f33e927c61a45a3f6d45f620e66a6bd535517c64c2fbabdd241bb4dfa82819a3")
POSEIDON16_PIN = (87655, "6831b6b4e480ccae3b09f2e19ba9f87050b0f0136358fa9510248928dffb663c")
LIB224_PIN = (86843, "b039c5610f10eb278154453303498dd449ffa4e5cc92deabd6574a5520e192ee")
# The reference's elliptic-curve point multiplication (examples/elliptic_torch.py:
# pointmul.aa from the port's stdlib, 8 registers x 256 steps over P224, ext
# 16, 48/24 queries; its constraints divide by registers): the port's proof
# on the CPU (tests/test_torch_script.py's slow test holds it to the JAX
# package's).
POINTMUL_PIN = (80901, "1ae96e3fba29bbd5bbe889726d0f68e73a6885a004e7478788c7d5cc738ad44f")
# The reference's two demos: the fibonacci at its largest size (2^17 steps,
# p32, default options: ext 4, 80/40 queries, sha256; Ne = 2^19) and the
# static-variables demo at its own (64 steps over the field 96769: L = 2,
# not of solinas form, the radix-2 route; Ne = 256).  The JAX package's
# proofs on the CPU (tests/test_torch_examples.py holds the port to both;
# its slow tests remake them).
FIB_STEPS = 2 ** 17
FIB_PIN = (150506, "d587e78a6557cba93d5f8bc10689bbcc3859258a6ca6577b9e071ffd4269c663")
DEMO_STEPS = 64
DEMO_MODULUS = 96769
DEMO_PIN = (6744, "5b934baaabb63a82243317f415cd033047af8f07860844e1453811a611dcc5b4")


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
    from genstark_tpu_torch.field.limbs import ints_to_limbs
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


# The limb counts of the port's fields (P32, P64, P128, P224, P256, and the
# solinas moduli of 96, 160 and 192 bits at L = 6, 10, 12):
# kernels.FIELD_LS.
FIELD_LIMBS = (2, 4, 6, 8, 10, 12, 14, 16)


def dft_ks() -> dict:
    """Kernel 1's k steps a slice at each L, as kernels.dft_slice gives them
    (the host mirror of csrc/dft_level.cu dft_ks): a level of m <= 32 runs
    one k step at every L, a larger one the slice's."""
    from genstark_tpu_torch import kernels
    return {L: (1, 2) if kernels.dft_slice(L) == 64 else (1,) for L in FIELD_LIMBS}


def mangled(name: str, *args: int) -> str:
    """The part of gs::name<args...>'s mangled name that names it:
    mangled("field_ew_kernel", 8, 0) = "15field_ew_kernelILi8ELi0EE"."""
    return f"{len(name)}{name}I" + "".join(f"Li{a}E" for a in args) + "E"


def word_kernels() -> tuple:
    """Every instantiation moved to the word product in one piece: kernel 5
    at K = L/2 for mul, add and sub, kernels 8 and 7/9 at L, kernel 10 at K.
    And kernel 1 at every limb count and k step of dft_ks(), whose A
    fragments stay in registers.  Each must be in the build's register
    report, without a spill."""
    ks = dft_ks()
    return tuple(
        [mangled("field_ew_kernel", L // 2, op) for L in FIELD_LIMBS for op in (0, 1, 2)]
        + [mangled(k, L) for k in ("butterfly_kernel", "butterfly_stages_kernel")
           for L in FIELD_LIMBS]
        + [mangled("mont_chain_kernel", L // 2) for L in FIELD_LIMBS]
        + [mangled("dft_level_kernel", L, k) for L in FIELD_LIMBS for k in ks[L]])


def is_port_kernel(name: str) -> bool:
    """A device kernel of the port's CUDA sources (namespace gs), by the
    profiler's (demangled or mangled) name."""
    return "gs::" in name or "_ZN2gs" in name


def profile_run(fn, reps: int = 1):
    """(by_name, stages, wall_ms) of `reps` calls of fn() under
    torch.profiler: the device time of every kernel, summed by name,
    {name: (us, launches)} (empty when the profiler records no device
    activity); the host wall of the prover's stage ranges (`prove.*`, which
    the profiler also reports on the device's timeline, where they are left
    out); and the calls' wall milliseconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_name, stages = {}, {}
    for e in prof.events():
        if e.name.startswith("prove."):
            if e.device_type == DeviceType.CPU:
                stages[e.name] = stages.get(e.name, 0.0) + e.time_range.elapsed_us()
        elif e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return by_name, stages, wall_ms


def device_ms(fn, reps: int = 20, per_call: int = 1):
    """Mean device milliseconds per call of the port's kernels that fn()
    launches, `per_call` launches a call (torch.profiler over `reps` calls
    after one warm-up): the kernel's own time, without the Python wrapper's
    host cost that CUDA-event means (chip_smoke.py's `cuda_ms`) include for
    short kernels.  The mean is taken over the launches the profiler
    recorded, which may miss a few.  None when the profiler sees no port
    kernel."""
    import torch
    fn()
    torch.cuda.synchronize()
    port = [(t, n) for name, (t, n) in profile_run(fn, reps)[0].items() if is_port_kernel(name)]
    count = sum(n for _, n in port)
    return sum(t for t, _ in port) / count / 1e3 * per_call if count else None


def random_elements(rng, modulus: int, L: int, n: int):
    """u32 [L, n] canonical limbs: random limbs, top limb kept below the
    modulus's top limb (so every value is < p)."""
    import numpy as np
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, modulus >> (16 * (L - 1)), size=n)
    return limbs.astype(np.uint32)


# Elements (m x columns) of one call of the plain DFT level (`plain_level`
# chunks a level by columns): its float64 digit products hold D^2 = 289
# values an element at p128, 2.4 GB at 2^20 elements.
PLAIN_LEVEL_ELEMS = 1 << 20


def plain_level(dev, w8, x, m: int, rest: int, tw, out_digits: bool = False):
    """`run_dft_level_ref` over column chunks of PLAIN_LEVEL_ELEMS / m
    columns, the same contract: unchunked, a p128 level of 2^25 points would
    hold 77 GB of float64 digit products.  A chunk narrower than `rest` lies
    inside one period of the twiddle; it takes the factored pair's rows of A
    for its columns (direct panels have rest <= 64, below every chunk)."""
    import torch
    from genstark_tpu_torch.ntt import dft
    if x.dim() == 4:                 # the transform's view [planes, pre, m, r]
        x = x.permute(0, 2, 1, 3).reshape(x.shape[0], m, x.shape[1] * x.shape[3])
    cols = x.shape[2]
    chunk = max(1, min(cols, PLAIN_LEVEL_ELEMS // m))
    parts = []
    for i0 in range(0, cols, chunk):
        tw_c, rest_c = tw, rest
        if rest > chunk:
            if "a" not in tw:
                raise ValueError(f"a direct twiddle panel of rest {rest} > {chunk} columns")
            s = tw["b"].shape[-1]
            if chunk % s:
                raise ValueError(f"a chunk of {chunk} columns splits the twiddle's s = {s}")
            h0 = (i0 % rest) // s
            tw_c, rest_c = {"a": tw["a"][h0:h0 + chunk // s], "b": tw["b"]}, chunk
        parts.append(dft.run_dft_level_ref(dev, w8, x[:, :, i0:i0 + chunk], m, rest_c, tw_c,
                                           out_digits))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


# The card's memory rate for the bytes bound (H100 SXM data sheet).
MEM_BYTES_PER_S = 3.35e12
# Operand sets a timed kernel-5 call turns through, so that its inputs and
# output come from device memory and not from the card's 50 MB L2, as its
# bytes bound counts them: 8 sets of a, b and out at [16, 2^17], 192 MiB.
DRAM_SETS = 8


def in_turn(fn, sets):
    """A call of fn on the next of `sets` (argument tuples) in turn; each
    result is kept until its set comes round again, so every set writes
    its own output buffer."""
    outs, turn = [None] * len(sets), [0]

    def call():
        i = turn[0] = (turn[0] + 1) % len(sets)
        outs[i] = None
        outs[i] = fn(*sets[i])
    return call


def candidates_needed(seed: bytes, count: int, max_: int, excl: int) -> int:
    """Candidates the host sampler (protocol/queries.py) hashes before its
    set is complete: the work this seed's set needs."""
    from genstark_tpu_torch.protocol.queries import _sha256_int
    state, taken, i = _sha256_int(seed), set(), 0
    while len(taken) < count:
        index = _sha256_int(state + i) % max_
        if not (excl and index % excl == 0):
            taken.add(index)
        i += 1
    return i


def odd_hex_roots(rng, n: int, count: int, max_: int, excl: int):
    """n roots (int32 [n, 8] LE words) whose state sha256(root) has an odd
    hex length (a zero top nibble), each needing more candidates than one
    window of kernel B (256) for its set: found on the host with
    candidates_needed."""
    import hashlib
    import numpy as np
    out = []
    while len(out) < n:
        root = rng.integers(0, 256, size=32, dtype=np.uint8).tobytes()
        if (hashlib.sha256(root).digest()[0] >> 4 == 0
                and candidates_needed(root, count, max_, excl) > 256):
            out.append(np.frombuffer(root, dtype="<u4").view(np.int32))
    return np.stack(out)


# The runtime's synchronizing calls, whose host time is the wait.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpyAsync")


def count_syncs(kernels, fn) -> dict:
    """The synchronizing calls of one call of fn() (a warm prove): torch's
    sync debug mode reports each one ("warn"; each warning recorded with
    its site in the port and the port kernel launches made before it, a
    replay of a Prover's recorded graph counted as launches:
    `after_first_kernel` counts those made after the call's first port
    kernel); then torch.profiler over a second call gives the host ms spent
    in the runtime's synchronizing calls (`host_wait_ms`, None where the
    profiler records none)."""
    import traceback
    import warnings
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from genstark_tpu_torch import tracing
    launched = lambda: sum(kernels.launch_counts.values()) + tracing.counters["graph_replays"]
    torch.cuda.synchronize()
    start, records = launched(), []

    def show(message, category, filename, lineno, file=None, line=None):
        # a sync's warning, not torch's one-time notice that the mode is a
        # prototype (which speaks of "synchronizing operations" too)
        text = str(message)
        if "synchroniz" in text and "prototype" not in text:
            # the innermost frame of the port (torch names its C++ source)
            # that is neither tracing's sync helper nor this hook
            frames = [f for f in traceback.extract_stack() if "genstark_tpu_torch" in f.filename
                      and os.path.basename(f.filename) not in ("tracing.py", "testing.py")]
            site = (f"{os.path.basename(frames[-1].filename)}:{frames[-1].lineno} "
                    f"{frames[-1].name}" if frames else f"{filename}:{lineno}")
            records.append((launched() - start, site))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    waits = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in SYNC_CALLS:
            us, n = waits.get(e.name, (0.0, 0))
            waits[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    sites = {}
    for _, site in records:
        sites[site] = sites.get(site, 0) + 1
    return {"syncs": len(records), "after_first_kernel": sum(n > 0 for n, _ in records),
            "sites": sites,
            "host_wait_ms": sum(us for us, _ in waits.values()) / 1e3 if waits else None,
            "wait_calls": {k: [round(us / 1e3, 4), n] for k, (us, n) in waits.items()}}


def ptxas_report(log: str):
    """(kernel, 'N registers, S bytes spilled') per kernel entry in nvcc's
    `-Xptxas -v` output; a name is the mangled one, e.g.
    _ZN2gs17lcomb_tail_kernelILi16EEEv... for lcomb_tail_kernel<16>."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            name, spill = line.split("for", 1)[1].strip(), ""
        elif "spill stores" in line:
            parts = line.replace(",", "").split()
            spill = f", {int(parts[4]) + int(parts[8])} bytes spilled"
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used", 1)[1].split("registers")[0].strip()
            out.append((name, f"{regs} registers{spill or ', no spills'}"))
            name = None
    return out
