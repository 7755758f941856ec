"""Kernel 5's device time at its reported shape (P256, [16, 2^17]: mul, add
and sub) with its operands read from device memory and from L2, for the
port in a given tree of this repository.

    python3 scripts/torch_ew_dram.py [--root DIR] [--rounds N]

Needs one CUDA card and the CUDA toolkit.  DIR (default: this checkout) is
a tree of this repository, e.g. an earlier commit unpacked with `git
archive`: its `genstark_tpu_torch` is imported and its kernels built in its
own `_build/`.  The instrument is this checkout's `chip_smoke.py`
(`in_turn` over `DRAM_SETS` operand sets, 192 MiB with the outputs, four
times the card's 50 MB L2; `device_ms`), so two trees run in turns are
measured alike.  Each of N rounds times every op over the sets in turn
(from device memory) and over one set (from L2), 48 calls each after a
warm-up, each result first checked against the plain version.  Prints one
JSON line: per op the rounds' device ms both ways, the bytes bound (3 L 4
n bytes at 3.35 TB/s) and the card's `nvidia-smi` name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_instrument():
    spec = importlib.util.spec_from_file_location("chip_smoke_instrument",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_ew_dram: no CUDA card", file=sys.stderr)
        return 1
    smoke = load_instrument()
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.field import P256, create_prime_field
    if not os.path.abspath(kernels.__file__).startswith(root + os.sep):
        print(f"torch_ew_dram: imported {kernels.__file__}, not the tree {root}",
              file=sys.stderr)
        return 1
    kernels.build()
    field = create_prime_field(P256)
    dev = field.device_field(torch.device("cuda", 0))
    n, rng = 2 ** 17, np.random.default_rng(7)
    sets = [tuple(dev.from_numpy(smoke.random_elements(rng, field.modulus, dev.L, n))
                  for _ in range(2)) for _ in range(smoke.DRAM_SETS)]
    out = {"tree": root, "shape": [dev.L, n], "sets": len(sets),
           "bytes_bound_ms": 3 * dev.L * 4 * n / smoke.MEM_BYTES_PER_S * 1e3}
    for op, ref in (("mul", dev.mont_mul_ref), ("add", dev.add_ref), ("sub", dev.sub_ref)):
        for a, b in sets:
            if not torch.equal(kernels.field_ew(dev, op, a, b), ref(a, b)):
                print(f"torch_ew_dram: {op} kernel != plain version", file=sys.stderr)
                return 1
        fn = lambda x, y, op=op: kernels.field_ew(dev, op, x, y)
        dram, l2 = [], []
        for _ in range(args.rounds):
            dram.append(smoke.device_ms(smoke.in_turn(fn, sets), reps=48))
            l2.append(smoke.device_ms(lambda: fn(*sets[0]), reps=48))
        out[op] = {"dram_device_ms": dram, "l2_device_ms": l2}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    out["card"] = smi.stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
