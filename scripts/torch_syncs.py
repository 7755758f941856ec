"""Synchronizing calls, launches, device busy share and prove seconds of a
warm prove on each main path of the PyTorch port, for the port in a given
tree of this repository.

    python3 scripts/torch_syncs.py [--root DIR] [--paths bench,mimc256,...] [--out FILE]

Needs one CUDA card and the CUDA toolkit.  DIR (default: this checkout) is
a tree of this repository, e.g. an earlier commit unpacked with `git
archive`: its `genstark_tpu_torch` and `examples` are imported, and its
kernels built in its own `_build/`.  The instrument is this checkout's
`chip_smoke.py` (`count_syncs`, `profile_run`, `host_fallbacks`), so two
trees run in turns are measured alike.  Per path, after two warm-up
proves: the port kernel launches of one prove (by kernel), prove seconds (best of 5, 3
at 2^20 steps and more) and their peak device memory, the synchronizing calls of one prove (all of them, and
those after its first port kernel) with the host milliseconds spent in the
runtime's synchronizing calls, and one profiled prove's device kernel
time, launches, busy share, each port kernel's device ms and launches
(`port_kernels_ms`) and the host wall of its `prove.*` stages.  One
JSON line a path (also appended to FILE), then the card's `nvidia-smi`
name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("bench", "mimc256", "rescue-merkle-16", "poseidon-merkle-16", "lib224-merkle-8",
         "pointmul", "fibonacci", "demo-static", "mimc256-2^18", "mimc256-2^20",
         "mimc64-2^18", "mimc128-2^17", "mimc128-2^20", "mimc128-2^21")
# Paths of 2^20 steps and more: best of 3, not 5.
LONG_PATHS = ("mimc256-2^20", "mimc128-2^20", "mimc128-2^21")


def load_instrument():
    spec = importlib.util.spec_from_file_location("chip_smoke_instrument",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_path(label: str, device, smoke):
    """(stark, assertions, inputs) of one main path, as chip_smoke.py
    drives it."""
    from examples import elliptic_torch, merkle_import_torch, poseidon_torch, rescue_torch
    from genstark_tpu_torch.field import P64, P128, P256
    from mimc_torch import make_mimc_stark
    mimc = {"bench": (2 ** 13, P128), "mimc256": (2 ** 13, P256),
            "mimc256-2^18": (2 ** 18, P256), "mimc256-2^20": (2 ** 20, P256),
            "mimc64-2^18": (2 ** 18, P64),
            "mimc128-2^17": (2 ** 17, P128), "mimc128-2^20": (2 ** 20, P128),
            "mimc128-2^21": (2 ** 21, P128)}
    if label in mimc:
        steps, modulus = mimc[label]
        stark, constants = make_mimc_stark(steps, device, modulus=modulus)
        return stark, smoke.mimc_assertions(stark, constants, steps), [[3]]
    if label == "rescue-merkle-16":
        return rescue_torch.branch_case(16, 42, None, device)[:3]
    if label == "poseidon-merkle-16":
        return poseidon_torch.branch_case(16, 42, None, device)[:3]
    if label == "lib224-merkle-8":
        return merkle_import_torch.merkle_proof_case(8, 42, None, device)[:3]
    if label == "pointmul":
        return elliptic_torch.pointmul_case(None, device)[:3]
    if label == "fibonacci":
        from examples import fibonacci_torch
        return fibonacci_torch.fib_case(smoke.FIB_STEPS, device=device)
    if label == "demo-static":
        from examples import demo_static_torch
        return demo_static_torch.demo_case(smoke.DEMO_STEPS, device=device)
    raise ValueError(f"unknown path {label}")


def measure(label: str, device, smoke, kernels) -> dict:
    import torch
    stark, assertions, inputs = make_path(label, device, smoke)

    def prove():
        stark.prove(assertions, inputs)

    for _ in range(2):
        prove()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    prove()
    torch.cuda.synchronize()
    launches = {k: n for k, n in kernels.launch_counts.items() if n}
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3 if label in LONG_PATHS else 5):
        t0 = time.monotonic()
        prove()
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    peak = torch.cuda.max_memory_allocated()
    syncs = smoke.count_syncs(kernels, prove)
    by_name, stages, wall_ms = smoke.profile_run(prove)
    device_ms = sum(us for us, _ in by_name.values()) / 1e3
    out = {"path": label, "prove_s_best": min(times), "prove_s": times,
           "peak_bytes": peak, "port_launches": sum(launches.values()),
           "launches": launches,
           "device_launches": sum(n for _, n in by_name.values()),
           "device_ms": device_ms, "profiled_wall_ms": wall_ms,
           "stages_ms": {k: us / 1e3 for k, us in stages.items()},
           "busy": device_ms / wall_ms if wall_ms else None,
           "port_kernels_ms": {k: [us / 1e3, n] for k, (us, n) in
                               sorted(smoke.port_totals(by_name).items())},
           "host_fallbacks": smoke.host_fallbacks(stark), **syncs}
    del stark
    torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--paths", default=",".join(PATHS))
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "examples")]
    import torch
    if not torch.cuda.is_available():
        print("torch_syncs: no CUDA card", file=sys.stderr)
        return 1
    smoke = load_instrument()
    from genstark_tpu_torch import kernels
    if not os.path.abspath(kernels.__file__).startswith(root + os.sep):
        print(f"torch_syncs: imported {kernels.__file__}, not the tree {root}", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    t0 = time.monotonic()
    kernels.build()
    print(f"tree {root}: kernel build {time.monotonic() - t0:.1f} s", flush=True)
    for label in args.paths.split(","):
        line = json.dumps(dict(measure(label, device, smoke, kernels), tree=root))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
