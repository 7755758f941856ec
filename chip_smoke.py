"""Chip smoke test of the PyTorch port: builds the CUDA kernels, checks each
against its plain torch version on the card, proves the pinned toy proofs,
the bench configuration (MiMC-128, 2^13 steps, secret input 3) and MiMC-256
at 2^13 steps (the radix-2 path), and prints one JSON line per contract at
the end.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc).  Imports nothing of JAX
or the JAX package.  Exits non-zero, printing no result, on any failure.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Pinned proof digests: (bytes, sha256) of the JAX package's proofs.
P32_PIN = (3472, "db79f92dcacf2cf2d1eeb7cee8db4a4eeb1e5bc5f4d13e9b0cdaacab7cc95b75")
P128_PIN = (7329, "3fa3bc9f84d3505912258df9974587b18b35619116a2787786b3beacd3cc4917")
# MiMC-128, 2^13 steps, blake2s256, ext 16, 48/24 queries, secret input 3:
# the JAX package's proof on the CPU (tests/test_torch_prover.py recomputes it).
BENCH_PIN = (97254, "3143467fcd3034ebdc758ce12b9501aa4b5f1c7efa57d5df8beaf153403fd928")
BENCH_STEPS = 2 ** 13
TOY = {"extension_factor": 4, "exe_query_count": 8, "fri_query_count": 6}
# MiMC over P256 = 2^256 - 351*2^32 + 1 (the reference's mimc256), 64 steps,
# 64 constants, secret input 3: the bench options and the toy options over
# P64 (tests/test_torch_prover_fields.py holds the same pins).
P256_64_PIN = (40300, "aeca982219743b04f13dd8b6be2b855f951bb16fd4c837f841d62af059265be4")
P64_64_PIN = (4614, "8f2cc12a4eea675682570374637c919519eb1c5628201c0d5b99a9a5892f6fe9")
# MiMC-256, 2^13 steps, the bench options, secret input 3: the JAX package's
# proof on the CPU (tests/test_torch_prover_fields.py recomputes it).
MIMC256_PIN = (118019, "da7b087ffccb38cf15a6bafd33a0905c30dddd81881229018dc3f6a3f6b97236")

# Kernels each main path must launch.
BENCH_KERNELS = ("dft_level", "hash_words", "hash_limbs", "lcomb_tail", "field_ew",
                 "outer_table")
MIMC256_KERNELS = ("hash_words", "hash_limbs", "lcomb_tail", "field_ew", "outer_table",
                   "butterfly")


class SmokeFailure(Exception):
    pass


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    require(tuple(a.shape) == tuple(b.shape), f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def random_elements(rng, modulus: int, L: int, n: int):
    """u32 [L, n] canonical limbs: random limbs, top limb kept below the
    modulus's top limb (so every value is < p)."""
    import numpy as np
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, modulus >> (16 * (L - 1)), size=n)
    return limbs.astype(np.uint32)


def check_dft(dev, field, rng, results):
    """Kernel 1 at the levels of the main path's 2^17-point transform, in
    every twiddle mode, limbs and digits out."""
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.ntt import DftPlan, dft
    n = 2 ** 17
    plan = DftPlan(field, dev, n, field.get_root_of_unity(n), 1)
    rest = n
    err, k_ms, p_ms = 0, 0.0, 0.0
    for lvl, m in enumerate(plan.levels):
        rest //= m
        cols = n // m
        x = dev.from_numpy(random_elements(rng, field.modulus, dev.L, m * cols))
        x8 = dft.encode_digits(x.reshape(dev.L, m, cols)).contiguous()
        tw = plan.tws[lvl] if rest > 1 else None
        mode = "none" if tw is None else ("direct" if "p" in tw else "factored")
        for out_digits in (False, True):
            args = (dev, plan.w8s[lvl], x8, m, rest, tw, out_digits)
            got = kernels.dft_level(*args)
            want = dft.run_dft_level_ref(*args)
            e = max_abs_err(got, want)
            km = cuda_ms(lambda: kernels.dft_level(*args))
            pm = cuda_ms(lambda: dft.run_dft_level_ref(*args), reps=2)
            print(f"dft_level p{field.modulus.bit_length()} m={m} cols={cols} rest={rest} "
                  f"{mode} {'digits' if out_digits else 'limbs'}: max_abs_err={e} "
                  f"kernel {km:.4f} ms plain {pm:.4f} ms", flush=True)
            require(e == 0, "dft_level kernel != plain version")
            err = max(err, e)
            # the main path's transform: digits out except the last level
            if field.modulus.bit_length() == 128 and out_digits == (lvl < len(plan.levels) - 1):
                k_ms += km
                p_ms += pm
    results["dft_level"]["max_abs_err"] = max(results["dft_level"]["max_abs_err"], err)
    if field.modulus.bit_length() == 128:
        results["dft_level"].update(ms=k_ms, plain_ms=p_ms)


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
            r.update(ms=km, plain_ms=pm)


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
            r.update(ms=km, plain_ms=pm)


def check_tail(dev, field, rng, results, record_times: bool = True):
    """Kernel 4 at the bench shape: Ne = 2^17, B = 1, V = 2, raised copies
    on, factored tables with s = 256 (L = 8 for p128, 16 for p256)."""
    import numpy as np
    from genstark_tpu_torch.field.limbs import power_series_mont_np
    from genstark_tpu_torch.protocol.lincomb_kernel import lcomb_tail, lcomb_tail_ref
    Ne, s, ext, B, V = 2 ** 17, 256, 16, 1, 2
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
    pm = cuda_ms(lambda: lcomb_tail_ref(*args), reps=2)
    print(f"lcomb_tail Ne={Ne} L={L} B={B} V={V}: max_abs_err={e} "
          f"kernel {km:.4f} ms plain {pm:.4f} ms", flush=True)
    require(e == 0, "lcomb_tail kernel != plain version")
    r = results["lcomb_tail"]
    r["max_abs_err"] = max(r["max_abs_err"], e)
    if record_times:
        r.update(ms=km, plain_ms=pm)


def p_minus_1(field, n: int):
    from genstark_tpu_torch.field.limbs import ints_to_limbs
    return ints_to_limbs([field.modulus - 1] * n, field.params.L)


def check_field_ew(device, fields, rng, results):
    """Kernel 5 at every L: mul, add and sub with same-shape operands, a
    scalar on either side and p - 1 everywhere, at [L, 2^15]; at the
    path's [16, 2^17] for P256, whose mul is the kernel's reported time."""
    from genstark_tpu_torch import kernels
    r = results["field_ew"]
    for field in fields:
        dev = field.device_field(device)
        sizes = (2 ** 15, 2 ** 17) if dev.L == 16 else (2 ** 15,)
        for n in sizes:
            a = dev.from_numpy(random_elements(rng, field.modulus, dev.L, n))
            b = dev.from_numpy(random_elements(rng, field.modulus, dev.L, n))
            c = dev.from_numpy(random_elements(rng, field.modulus, dev.L, 1))
            pm1 = dev.from_numpy(p_minus_1(field, n))
            for op, ref in (("mul", dev.mont_mul_ref), ("add", dev.add_ref),
                            ("sub", dev.sub_ref)):
                err = 0
                for x, y in ((a, b), (a, c), (c, a), (pm1, pm1)):
                    err = max(err, max_abs_err(kernels.field_ew(dev, op, x, y), ref(x, y)))
                km = cuda_ms(lambda: kernels.field_ew(dev, op, a, b))
                pm = cuda_ms(lambda: ref(a, b), reps=2)
                print(f"field_ew p{field.modulus.bit_length()} L={dev.L} {op} [L, {n}] "
                      f"(same shape, scalar right, scalar left, p-1): max_abs_err={err} "
                      f"kernel {km:.4f} ms plain {pm:.4f} ms", flush=True)
                require(err == 0, "field_ew kernel != plain version")
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if dev.L == 16 and n == 2 ** 17 and op == "mul":
                    r.update(ms=km, plain_ms=pm)


def check_outer(device, fields, rng, results):
    """Kernel 6 at the path's factored tables: s = 256, nj = 512."""
    from genstark_tpu_torch import kernels
    r = results["outer_table"]
    for field in fields:
        dev = field.device_field(device)
        outer = dev.from_numpy(random_elements(rng, field.modulus, dev.L, 512))
        inner = dev.from_numpy(random_elements(rng, field.modulus, dev.L, 256))
        e = max_abs_err(kernels.outer_table(dev, outer, inner), dev.outer_table_ref(outer, inner))
        km = cuda_ms(lambda: kernels.outer_table(dev, outer, inner))
        pm = cuda_ms(lambda: dev.outer_table_ref(outer, inner), reps=2)
        print(f"outer_table p{field.modulus.bit_length()} L={dev.L} nj=512 s=256: "
              f"max_abs_err={e} kernel {km:.4f} ms plain {pm:.4f} ms", flush=True)
        require(e == 0, "outer_table kernel != plain version")
        r["max_abs_err"] = max(r["max_abs_err"], e)
        if dev.L == 16:
            r.update(ms=km, plain_ms=pm)


def check_butterfly(device, fields, rng, results):
    """Kernel 8 at every L: a direct 2048-point local transform, and both
    passes of the four-step split of the path's 2^13-, 2^15- and 2^17-point
    transforms, in the strided layouts the transform gives them; then one
    whole 2^17-point transform (kernels 8 and 5) against the plain path.
    The reported time is the two passes of the P256 2^17-point transform."""
    import torch
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.ntt import radix2
    r = results["butterfly"]
    for field in fields:
        dev = field.device_field(device)
        L = dev.L
        for n in (2048, 2 ** 13, 2 ** 15, 2 ** 17):
            plan = radix2.Radix2Plan(field, dev, n, field.get_root_of_unity(n),
                                     field.inv(field.params.R_mod % field.modulus))
            if plan.split is None:
                x = dev.from_numpy(random_elements(rng, field.modulus, L, n)).reshape(1, 1, L, n)
                calls = [(x, plan.tables[0], None)]
            else:
                n1, n2 = plan.split
                x = dev.from_numpy(random_elements(rng, field.modulus, L, n))
                y = torch.empty((L, 1, n1, n2), dtype=torch.int32, device=device)
                out = torch.empty((1, L, n2, n1), dtype=torch.int32, device=device)
                calls = [(x.reshape(1, L, n1, n2).permute(0, 3, 1, 2), plan.tables[0],
                          y.permute(1, 3, 0, 2)),
                         (x.reshape(L, 1, n1, n2).permute(1, 2, 0, 3), plan.tables[1],
                          out.permute(0, 3, 1, 2))]
            err, km, pm = 0, 0.0, 0.0
            for xin, tab, o in calls:
                got = kernels.butterfly(dev, xin, tab, o)
                want = radix2.butterfly_ref(dev, xin, tab)
                err = max(err, max_abs_err(got, want))
                km += cuda_ms(lambda: kernels.butterfly(dev, xin, tab, o))
                pm += cuda_ms(lambda: radix2.butterfly_ref(dev, xin, tab), reps=2)
            print(f"butterfly p{field.modulus.bit_length()} L={L} n={n} local "
                  f"{plan.split or (n,)}: max_abs_err={err} kernel {km:.4f} ms "
                  f"plain {pm:.4f} ms", flush=True)
            require(err == 0, "butterfly kernel != plain version")
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if L == 16 and n == 2 ** 17:
                r.update(ms=km, plain_ms=pm)
            if n == 2 ** 17:
                xb = dev.from_numpy(random_elements(rng, field.modulus, L, 2 * n))
                xb = xb.reshape(L, 2, n).permute(1, 0, 2)
                e = max_abs_err(radix2.transform(dev, xb, plan),
                                radix2.transform_ref(dev, xb, plan))
                print(f"radix-2 transform p{field.modulus.bit_length()} n={n} B=2 (R^-1 "
                      f"folded), kernel path vs plain path: max_abs_err={e}", flush=True)
                require(e == 0, "radix-2 transform (kernels 8, 5) != plain path")


def profile_prove(stark, assertions) -> None:
    """Device kernel time by name over one prove, and the device's busy
    share of the wall time.  A measurement only: a profiler that captures
    nothing is reported, not fatal."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            stark.prove(assertions, [[3]])
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
        by_name, stages = {}, {}
        for e in prof.events():
            if e.name.startswith("prove."):     # the prover's stage ranges
                if e.device_type == DeviceType.CPU:
                    stages[e.name] = stages.get(e.name, 0.0) + e.time_range.elapsed_us()
            elif e.device_type == DeviceType.CUDA:
                us, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    except Exception as err:  # noqa: BLE001 - measurement boundary
        print(f"profiler failed: {err!r}", flush=True)
        return
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    print(f"profiled prove wall {wall_ms:.3f} ms, device kernels {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% busy), {sum(n for _, n in by_name.values())} "
          f"kernel launches", flush=True)
    for name, us in stages.items():
        print(f"  stage {name}: host wall {us / 1e3:.3f} ms", flush=True)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / 1e3:9.3f} ms {n:6d}x  {name[:100]}", flush=True)


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


def proof_digest(data: bytes):
    return len(data), hashlib.sha256(data).hexdigest()


def run_main_path(kernels, stark, constants, pin, required, label: str) -> dict:
    """One main path (MiMC, BENCH_STEPS steps, secret input 3): a warm-up
    prove; the launch counts set to 0, one prove checked against its pin,
    the counts read; best of 5 and the spread of 20 proves; one profiled
    prove.  Returns the launches."""
    import torch
    from mimc_torch import run_mimc
    from genstark_tpu_torch.protocol import Assertion
    controls = run_mimc(stark.air.field, BENCH_STEPS, constants, 3)
    assertions = [Assertion(0, 0, controls[0]), Assertion(BENCH_STEPS - 1, 0, controls[-1])]
    t0 = time.monotonic()
    stark.prove(assertions, [[3]])
    torch.cuda.synchronize()
    warmup = time.monotonic() - t0
    kernels.reset_launch_counts()
    data = stark.serialize(stark.prove(assertions, [[3]]))
    launches = dict(kernels.launch_counts)
    got = proof_digest(data)
    print(f"{label} proof: {got[0]} bytes sha256 {got[1]}", flush=True)
    print(f"{label} launches in one prove: {launches}", flush=True)
    require(got == pin, f"{label} proof differs from the JAX pin {pin}")
    missing = [k for k in required if launches[k] == 0]
    require(not missing, f"{label}: kernels of the path never launched: {missing}")
    times = []
    for _ in range(20):
        t0 = time.monotonic()
        stark.prove(assertions, [[3]])
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    ranked = sorted(times)
    print(f"{label} warmup {warmup:.4f} s; prove best-of-5 {min(times[:5]):.6f} s; over "
          f"{len(times)} proves median {ranked[len(ranked) // 2]:.6f} s, min "
          f"{ranked[0]:.6f} s, max {ranked[-1]:.6f} s; security {stark.security_level}",
          flush=True)
    print(f"{label} prove seconds: {[round(t, 6) for t in times]}", flush=True)
    phase(f"{label}: where the time goes (torch.profiler, one prove)")
    profile_prove(stark, assertions)
    return launches


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
    sys.path.insert(0, os.path.join(HERE, "examples"))
    from mimc_torch import make_mimc_stark, prove_mimc, run_mimc
    from genstark_tpu_torch.protocol import Assertion

    phase("build")
    t0 = time.monotonic()
    kernels.build()
    print(f"kernel build {time.monotonic() - t0:.1f} s", flush=True)
    for name, report in ptxas_report(kernels.build_info.get("log", "")):
        print(f"ptxas: {name}: {report}", flush=True)

    phase("kernels vs plain versions (exact, tolerance 0)")
    meta = {
        "dft_level": ("genstark_tpu_torch/csrc/dft_level.cu", "genstark_tpu/ntt/mxu.py:356"),
        "hash_words": ("genstark_tpu_torch/csrc/hash.cu", "genstark_tpu/hash/pallas_hash.py:182"),
        "hash_limbs": ("genstark_tpu_torch/csrc/hash.cu", "genstark_tpu/hash/pallas_hash.py:200"),
        "lcomb_tail": ("genstark_tpu_torch/csrc/lcomb_tail.cu",
                       "genstark_tpu/protocol/lincomb_kernel.py:47"),
        "field_ew": ("genstark_tpu_torch/csrc/field_ops.cu", "genstark_tpu/field/pallas_ops.py:34"),
        "outer_table": ("genstark_tpu_torch/csrc/field_ops.cu",
                        "genstark_tpu/field/pallas_ops.py:79"),
        "butterfly": ("genstark_tpu_torch/csrc/butterfly.cu",
                      "genstark_tpu/ntt/pallas_kernels.py:204"),
    }
    results = {k: {"max_abs_err": 0, "ms": None, "plain_ms": None} for k in meta}
    rng = np.random.default_rng(2024)
    f128, f32 = create_prime_field(P128), create_prime_field(P32)
    dev128, dev32 = f128.device_field(device), f32.device_field(device)
    check_dft(dev128, f128, rng, results)
    check_dft(dev32, f32, rng, results)
    check_hash_words(dev128, rng, results)
    check_hash_limbs(dev128, f128, rng, results)
    check_tail(dev128, f128, rng, results)
    all_fields = [create_prime_field(m) for m in (P32, P64, P128, P224, P256)]
    f256 = all_fields[-1]
    dev256 = f256.device_field(device)
    check_field_ew(device, all_fields, rng, results)
    check_outer(device, [f128, f256], rng, results)
    check_butterfly(device, all_fields, rng, results)
    check_hash_limbs(dev256, f256, rng, results, record_times=False)
    check_tail(dev256, f256, rng, results, record_times=False)
    torch.cuda.synchronize()

    phase("pinned toy proofs on the card")
    for modulus, count, pin in ((P32, 16, P32_PIN), (P128, 32, P128_PIN)):
        stark, constants = make_mimc_stark(64, device, modulus=modulus, use_input=False,
                                           constant_count=count, options=TOY)
        controls = run_mimc(stark.air.field, 64, constants, 3)
        data = stark.serialize(stark.prove(
            [Assertion(0, 0, controls[0]), Assertion(63, 0, controls[-1])], [], [3]))
        got = proof_digest(data)
        print(f"p{modulus.bit_length()} pin: {got[0]} bytes sha256 {got[1]}", flush=True)
        require(got == pin, f"p{modulus.bit_length()} proof differs from its pin {pin}")
    for modulus, options, pin in ((P256, None, P256_64_PIN), (P64, TOY, P64_64_PIN)):
        _, data = prove_mimc(64, device, modulus=modulus, options=options)
        got = proof_digest(data)
        print(f"p{modulus.bit_length()} secret-input pin: {got[0]} bytes sha256 {got[1]}",
              flush=True)
        require(got == pin, f"p{modulus.bit_length()} proof differs from its pin {pin}")

    phase(f"bench config: MiMC-128, {BENCH_STEPS} steps, secret input 3")
    bench_launches = run_main_path(kernels, *make_mimc_stark(BENCH_STEPS, device),
                                   BENCH_PIN, BENCH_KERNELS, "bench")

    phase(f"MiMC-256: P256, {BENCH_STEPS} steps, secret input 3 (radix-2 path)")
    mimc256_launches = run_main_path(
        kernels, *make_mimc_stark(BENCH_STEPS, device, modulus=P256), MIMC256_PIN,
        MIMC256_KERNELS, "mimc256")
    launches = {k: bench_launches[k] + mimc256_launches[k] for k in meta}

    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
        for name in meta]}
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
