"""Layer: ntt/ (kernels 1, 7/9 and 8).  After the window, the port's public
`ntt.intt` (n points) and `ntt.low_degree_extend` (n -> Ne) on one [L, n]
vector at the cell's own sizes, timed together with CUDA events after a
warm-up, the least of REPEATS calls.  The share is the least time the
card's memory allows, each byte of the transforms' inputs read once and of
their outputs written once at the published HBM rate (peaks.json), over
the measured time.  Bytes only: the operation count depends on the route
(int8 digit products or word products), the bytes do not."""

import json
from pathlib import Path

REPEATS = 5


def lde_bytes(L: int, n: int, Ne: int, word_bytes: int = 4) -> int:
    """intt reads and writes n elements, the LDE reads n and writes Ne; an
    element is L limbs of `word_bytes` bytes."""
    return (3 * n + Ne) * L * word_bytes


def read(run):
    if run.stark is None or run.device != "cuda":
        return None
    peaks = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())
    peak = peaks.get(run.device_kind)
    if peak is None:
        return None
    import torch
    from genstark_tpu_torch import ntt

    field = run.stark.air.field
    L, n, Ne = field.params.L, run.trace_length, run.evaluation_domain_size
    gen = torch.Generator(device="cuda").manual_seed(run.seed)
    # limbs below 2^15 keep every element below p
    x = torch.randint(0, 1 << 15, (L, n), dtype=torch.int32, device="cuda", generator=gen)
    best = None
    for i in range(REPEATS + 1):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        coeffs = ntt.intt(field, x)
        out = ntt.low_degree_extend(field, coeffs, Ne)
        stop.record()
        torch.cuda.synchronize()
        if i:
            ms = start.elapsed_time(stop)
            best = ms if best is None else min(best, ms)
    nbytes = x.numel() * x.element_size() + coeffs.numel() * coeffs.element_size() * 2 \
        + out.numel() * out.element_size()
    if nbytes != lde_bytes(L, n, Ne, x.element_size()):
        raise ValueError("the transforms' tensors are not the counted sizes")
    bound_ms = nbytes / peak["hbm_bytes_per_s"] * 1e3
    del x, coeffs, out
    return 100.0 * bound_ms / best
