"""The port's spans and sync counter (genstark_tpu_torch.tracing) on the
card, at each benchmark cell's configuration and traffic.

    python3 scripts/torch_spans.py [--cells a,b] [--out FILE]
    python3 scripts/torch_spans.py --idle CELL --seed N [--seconds S] [--out FILE]

Needs one CUDA card and the CUDA toolkit; run from the root of a checkout.
The first form, per cell, after two warm-up requests (prove + serialize)
of the cell's own statements:

- `syncs`: one request of a fresh statement under torch's sync debug mode
  (`genstark_tpu_torch.testing.count_syncs`: each synchronizing call and
  its site in the port) against the growth of `tracing.counters["syncs"]` over the same
  request; then the same for a warm request (a statement proved before);
- `clock`: three fresh requests under torch.profiler; each program span
  against the profiler's host range of the same name (the n-th against
  the n-th): the largest distance of either edge, in us;
- `cost`: the helper's us a span with no profiler and while the profiler
  records (empty spans, less the loop's own time), the spans a request,
  and the median of five fresh requests' ms with no profiler.

The second form runs the cell once with `--trace 1` (`benchmark.run`, no
pin) and prints its per-layer metrics and the card's idle seconds in the
traced window by the innermost program span the host was in
(`between_requests` outside every root span, `stark.prove` inside a prove
but in none of its stages).  One JSON line a cell, and nvidia-smi's name
and power limit; FILE gets the lines too.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from benchmark import cells, program, statements  # noqa: E402

CELLS = ("mimc128-2p20", "poseidon-merkle-d16")


class Requests:
    """The cell's Stark and its statements, proved in turn (each statement once)."""

    def __init__(self, name: str, seed: int, count: int):
        c = cells.cell(name)
        self.made = statements.make_all(c.config, c.traffic, seed, count)
        self.stark = program.build_stark(c.config, c.traffic, "cuda")
        self.next = 0

    def fresh(self) -> bytes:
        st = self.made[self.next]
        self.next += 1
        return program.prove(self.stark, st, program.assertions(st))

    def again(self) -> bytes:
        st = self.made[self.next - 1]
        return program.prove(self.stark, st, program.assertions(st))


def counted(fn, deltas):
    """fn, appending the growth of the sync counter over each call."""
    from genstark_tpu_torch import tracing

    def call():
        before = tracing.counters["syncs"]
        fn()
        deltas.append(tracing.counters["syncs"] - before)
    return call


def clock_check(reqs, n: int = 3) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from genstark_tpu_torch import tracing

    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            reqs.fresh()
    spans = tracing.recorded()
    names = {s.name for s in spans}
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in names:
            start = e.start_ns()
            ranges.setdefault(e.name(), []).append((start, start + e.duration_ns()))
    worst = {}
    for name in sorted(names):
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        theirs = sorted(ranges.get(name, []))
        if len(mine) != len(theirs):
            worst[name] = f"{len(mine)} spans, {len(theirs)} ranges"
            continue
        worst[name] = max(max(abs(a - c), abs(b - d))
                          for (a, b), (c, d) in zip(mine, theirs)) / 1e3
    return {"spans_per_request": len(spans) / n, "max_edge_us": worst}


def cost_check(reqs, n: int = 200_000) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from genstark_tpu_torch import tracing

    def per_span(count):
        t = time.perf_counter()
        for _ in range(count):
            pass
        loop = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(count):
            with tracing.span("cost"):
                pass
        return (time.perf_counter() - t - loop) / count * 1e6

    off = per_span(n)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = per_span(n // 10)
    tracing.clear()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        reqs.fresh()
        times.append((time.perf_counter() - t) * 1e3)
    return {"us_a_span_off": off, "us_a_span_on": on,
            "median_request_ms": statistics.median(times)}


def check_cell(name: str, seed: int) -> dict:
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.testing import count_syncs

    reqs = Requests(name, seed, 16)
    reqs.fresh()
    reqs.fresh()
    out = {"cell": name}
    for label, fn in (("fresh", reqs.fresh), ("warm", reqs.again)):
        deltas = []
        syncs = count_syncs(kernels, counted(fn, deltas))
        out[label] = {"torch_syncs": syncs["syncs"], "counted_syncs": deltas[0],
                      "sites": syncs["sites"], "host_wait_ms": syncs["host_wait_ms"]}
    out["clock"] = clock_check(reqs)
    out["cost"] = cost_check(reqs)
    c = out["cost"]
    c["share_off_pct"] = 100 * c["us_a_span_off"] * out["clock"]["spans_per_request"] \
        / 1e3 / c["median_request_ms"]
    c["share_on_pct"] = 100 * c["us_a_span_on"] * out["clock"]["spans_per_request"] \
        / 1e3 / c["median_request_ms"]
    return out


def idle_by_span(profile, spans) -> dict:
    """The card's idle seconds in the traced window by the innermost span
    the host was in."""
    w0, w1 = profile.window
    gaps, at = [], w0
    for s, e in profile.busy_intervals():
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if w1 > at:
        gaps.append((at, w1))
    totals = {}
    for g0, g1 in gaps:
        inside = [s for s in spans if s.start_ns < g1 and s.end_ns > g0]
        cuts = sorted({g0, g1} | {t for s in inside for t in (s.start_ns, s.end_ns)
                                  if g0 < t < g1})
        for t0, t1 in zip(cuts, cuts[1:]):
            mid = (t0 + t1) / 2
            inner = [s for s in inside if s.start_ns <= mid < s.end_ns]
            name = (min(inner, key=lambda s: s.end_ns - s.start_ns).name if inner
                    else "between_requests")
            totals[name] = totals.get(name, 0) + t1 - t0
    return {k: v / 1e9 for k, v in sorted(totals.items(), key=lambda kv: -kv[1])}


def idle_run(name: str, seed: int, seconds: float) -> dict:
    from benchmark import run, trace
    from genstark_tpu_torch import tracing

    captured = []
    from_profiler = trace.Profile.from_profiler.__func__

    def keep(cls, prof):
        captured.append(from_profiler(cls, prof))
        return captured[-1]
    trace.Profile.from_profiler = classmethod(keep)
    result = run.run_cell(cells.cell(name), seed, seconds, True)
    profile = captured[0]
    spans = [s for s in tracing.recorded() if any(
        a <= s.start_ns <= b for a, b in profile.requests)]
    return {"cell": name, "seed": seed, "metrics": {k: v["value"] for k, v in
                                                    result["metrics"].items()},
            "window_s": profile.window_ns() / 1e9, "busy_s": profile.busy_ns() / 1e9,
            "idle_by_span_s": idle_by_span(profile, spans), "correct": result["correct"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cells", default=",".join(CELLS))
    parser.add_argument("--idle", default=None)
    parser.add_argument("--seed", type=int, default=2 ** 31 + 12345)
    parser.add_argument("--seconds", type=float, default=51)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    lines = ([idle_run(args.idle, args.seed, args.seconds)] if args.idle else
             [check_cell(name, args.seed) for name in args.cells.split(",")])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for line in lines:
        line["card"] = smi
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
