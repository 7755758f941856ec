"""Chip smoke test of the PyTorch port: builds the CUDA kernels, checks each
against its plain torch version on the card, proves the two pinned toy
proofs and the bench configuration (MiMC-128, 2^13 steps, secret input 3),
and prints one JSON line per contract at the end.

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


def check_hash(dev, rng, results):
    """Kernels 2 and 3 at the slice's shapes, both algorithms, plus hashlib."""
    import numpy as np
    import torch
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.field import P128
    from genstark_tpu_torch.hash import digest_rows_ref, create_hash, digests_to_bytes, elements_to_words
    Ne = 2 ** 17
    for algo in ("blake2s256", "sha256"):
        h = create_hash(algo)
        # kernel 2: the first e-tree pair level (2^16 pairs of 64 bytes)
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

        # kernel 3: e-tree leaves (V = 2 vectors, L = 8) and FRI rows
        vecs = dev.from_numpy(np.stack([random_elements(rng, P128, 8, Ne) for _ in range(2)]))
        got = h.merge_element_rows(vecs, 16)
        wwords = torch.cat([elements_to_words(vecs[v]) for v in range(2)])
        want = digest_rows_ref(algo, wwords, 32)
        e1 = max_abs_err(got, want)
        raw = np.ascontiguousarray(vecs[:, :, :3].cpu().numpy().astype("<u2"))
        ref = [raw[0, :, i].tobytes() + raw[1, :, i].tobytes() for i in range(3)]
        require(digests_to_bytes(got[:, :3].cpu().numpy().view(np.uint32))
                == [h.digest(x) for x in ref], f"{algo} hash_limbs != hashlib")
        km = cuda_ms(lambda: h.merge_element_rows(vecs, 16))
        pm = cuda_ms(lambda: digest_rows_ref(algo, torch.cat(
            [elements_to_words(vecs[v]) for v in range(2)]), 32), reps=2)
        print(f"hash_limbs {algo} leaves V=2 B={Ne}: max_abs_err={e1} "
              f"kernel {km:.4f} ms plain {pm:.4f} ms", flush=True)
        layer = vecs[0]
        got = h.digest_stride_rows(layer, 16)
        M = Ne // 4
        want = digest_rows_ref(algo, torch.cat(
            [elements_to_words(layer[:, k * M:(k + 1) * M]) for k in range(4)]), 64)
        e2 = max_abs_err(got, want)
        km2 = cuda_ms(lambda: h.digest_stride_rows(layer, 16))
        print(f"hash_limbs {algo} stride4 M={M}: max_abs_err={e2} kernel {km2:.4f} ms",
              flush=True)
        require(e1 == 0 and e2 == 0, "hash_limbs kernel != plain version")
        r = results["hash_limbs"]
        r["max_abs_err"] = max(r["max_abs_err"], e1, e2)
        if algo == "blake2s256":
            r.update(ms=km, plain_ms=pm)


def check_tail(dev, field, rng, results):
    """Kernel 4 at the bench shape: Ne = 2^17, L = 8, B = 1, V = 2, raised
    copies on, factored tables with s = 256."""
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
    results["lcomb_tail"].update(max_abs_err=e, ms=km, plain_ms=pm)


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


def proof_digest(data: bytes):
    return len(data), hashlib.sha256(data).hexdigest()


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
    from genstark_tpu_torch.field import P32, P128, create_prime_field
    sys.path.insert(0, os.path.join(HERE, "examples"))
    from mimc_torch import make_mimc_stark, run_mimc
    from genstark_tpu_torch.protocol import Assertion

    phase("build")
    t0 = time.monotonic()
    kernels.build()
    print(f"kernel build {time.monotonic() - t0:.1f} s", flush=True)
    for line in kernels.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)

    phase("kernels vs plain versions (exact, tolerance 0)")
    meta = {
        "dft_level": ("genstark_tpu_torch/csrc/dft_level.cu", "genstark_tpu/ntt/mxu.py:356"),
        "hash_words": ("genstark_tpu_torch/csrc/hash.cu", "genstark_tpu/hash/pallas_hash.py:182"),
        "hash_limbs": ("genstark_tpu_torch/csrc/hash.cu", "genstark_tpu/hash/pallas_hash.py:200"),
        "lcomb_tail": ("genstark_tpu_torch/csrc/lcomb_tail.cu",
                       "genstark_tpu/protocol/lincomb_kernel.py:47"),
    }
    results = {k: {"max_abs_err": 0, "ms": None, "plain_ms": None} for k in meta}
    rng = np.random.default_rng(2024)
    f128, f32 = create_prime_field(P128), create_prime_field(P32)
    dev128, dev32 = f128.device_field(device), f32.device_field(device)
    check_dft(dev128, f128, rng, results)
    check_dft(dev32, f32, rng, results)
    check_hash(dev128, rng, results)
    check_tail(dev128, f128, rng, results)
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

    phase(f"bench config: MiMC-128, {BENCH_STEPS} steps, secret input 3")
    stark, constants = make_mimc_stark(BENCH_STEPS, device)
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
    print(f"bench proof: {got[0]} bytes sha256 {got[1]}", flush=True)
    print(f"launches in one prove: {launches}", flush=True)
    require(got == BENCH_PIN, f"bench proof differs from the JAX pin {BENCH_PIN}")
    require(all(v > 0 for v in launches.values()), "a kernel of the path never launched")
    times = []
    for _ in range(20):
        t0 = time.monotonic()
        stark.prove(assertions, [[3]])
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    ranked = sorted(times)
    print(f"warmup {warmup:.4f} s; prove best-of-5 {min(times[:5]):.6f} s; over "
          f"{len(times)} proves median {ranked[len(ranked) // 2]:.6f} s, min "
          f"{ranked[0]:.6f} s, max {ranked[-1]:.6f} s; security {stark.security_level}",
          flush=True)
    print(f"prove seconds: {[round(t, 6) for t in times]}", flush=True)

    phase("where the time goes (torch.profiler, one prove)")
    profile_prove(stark, assertions)

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
