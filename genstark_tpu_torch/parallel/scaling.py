"""Scaling harness of the distributed NTT.

Counterpart of ``genstark_tpu/parallel/scaling.py`` (`measure_ntt_scaling`,
`comm_compute_split`).  `measure_ntt_scaling` runs inside every rank of a
mesh (parallel/launch.py's `run_ranks`): it times the n-point forward
transform on the rank's device alone and `distributed_ntt` over the mesh.
`comm_compute_split` is the analytic split of the distributed transform
into local work and exchange, from a link bandwidth and a single-card
transform rate that the caller passes: this module holds no hardware
constant.  Ranks that share one card (the one-card test of the sharded
path) say nothing about scaling: their records carry a note that says so.

    python -m genstark_tpu_torch.parallel.scaling [n] [ranks] [device]

spawns the ranks over gloo on the card (`device` "cuda", the default) or on
the CPU ("cpu") and prints one JSON line a record.
"""

from __future__ import annotations

import json
import sys
import time
from typing import List

import torch

from .mesh import Mesh
from .ntt_dist import distributed_ntt

# Exchanges of one distributed transform from and to natural blocks
# (ntt_dist.py: the block-in reshard, the four-step's own, and the
# natural-order reshard).
EXCHANGES_BLOCK_TO_BLOCK = 3


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_best(fn, device, n_runs: int) -> float:
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(n_runs):
        t0 = time.monotonic()
        fn()
        _sync(device)
        best = min(best, time.monotonic() - t0)
    return best


def measure_ntt_scaling(mesh: Mesh, field=None, n: int = 2 ** 18,
                        n_runs: int = 5) -> List[dict]:
    """On each rank: the best of n_runs seconds of the n-point forward NTT
    on this rank's device alone and of `distributed_ntt` over the mesh.
    Returns [{"devices", "seconds", "butterflies_per_s", "speedup",
    "efficiency"} for 1 device, then for the mesh], efficiency = speedup /
    devices.  Where the ranks share a device (the CPU, or fewer cards than
    ranks) each record carries a note that the times are no scaling
    number."""
    from ..field import P128, create_prime_field
    from .. import ntt
    field = field or create_prime_field(P128)
    dev = field.device_field(mesh.device)
    x = dev.from_ints([3] * n)
    off, blk = mesh.block(n)
    block = x[:, off:off + blk].contiguous()
    butterflies = (n // 2) * (n.bit_length() - 1)
    base = _time_best(lambda: ntt.ntt(field, x), mesh.device, n_runs)
    t = _time_best(lambda: distributed_ntt(field, block, mesh), mesh.device, n_runs)
    out = [{"devices": 1, "seconds": base, "butterflies_per_s": butterflies / base,
            "speedup": 1.0, "efficiency": 1.0},
           {"devices": mesh.size, "seconds": t, "butterflies_per_s": butterflies / t,
            "speedup": base / t, "efficiency": base / t / mesh.size}]
    if mesh.device.type == "cpu" or torch.cuda.device_count() < mesh.size:
        for rec in out:
            rec["note"] = (f"{mesh.size} ranks sharing one {mesh.device.type} device over "
                           f"{mesh.backend}: wall-clock efficiency says nothing about "
                           "scaling; see the analytic split")
    return out


def comm_compute_split(n: int, devices: int, link_gbps: float, bf_per_s: float,
                       limbs: int = 8) -> dict:
    """The analytic split of one distributed n-point transform from and to
    natural blocks: local butterflies at the single-card rate `bf_per_s`
    (butterflies a second, measured by the caller) split D ways, against
    EXCHANGES_BLOCK_TO_BLOCK all_to_all_single exchanges, each moving
    (D - 1)/D of a rank's n/D elements of `limbs` 16-bit limbs (held as
    int32) over a link of `link_gbps` GB/s a direction."""
    elem_bytes = limbs * 4
    a2a_bytes = (n // devices) * elem_bytes * (devices - 1) // devices
    butterflies = (n // 2) * (n.bit_length() - 1)
    t_compute = butterflies / devices / bf_per_s
    t_comm = EXCHANGES_BLOCK_TO_BLOCK * a2a_bytes / (link_gbps * 1e9)
    return {
        "devices": devices,
        "all_to_all_bytes_per_device": a2a_bytes,
        "all_to_all_count": EXCHANGES_BLOCK_TO_BLOCK,
        "projected_compute_s": t_compute,
        "projected_comm_s": t_comm,
        "projected_efficiency": t_compute / (t_compute + t_comm),
        "model": f"link {link_gbps} GB/s a direction, {bf_per_s:.4e} butterflies/s a card "
                 "(both from the caller)",
    }


def _scaling_rank(mesh: Mesh, n: int) -> List[dict]:
    return measure_ntt_scaling(mesh, n=n)


def main() -> None:
    from .launch import run_ranks
    argv = sys.argv[1:]
    n = int(argv[0]) if argv else 2 ** 18
    ranks = int(argv[1]) if len(argv) > 1 else 4
    device = argv[2] if len(argv) > 2 else "cuda"
    for rec in run_ranks(_scaling_rank, ranks, "gloo", device, args=(n,), timeout_s=600)[0]:
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
