"""Reading a torch.profiler trace of the traced window.

The benchmark wraps each traced request in a `bench.request` range; the
port marks its one-fetch prove with `prove.commit`, `prove.lcomb`,
`prove.fri`, `prove.tail` and `prove.assemble` ranges.  `Profile` holds
those host ranges and every device operation, in nanoseconds on the
profiler's clock, and derives the busy time, the longest device
operations and the device's idle time by what the host was in.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Tuple

REQUEST = "bench.request"
STAGES = ("prove.commit", "prove.lcomb", "prove.fri", "prove.tail", "prove.assemble")

# The port's launch counters (kernels.launch_counts) and the CUDA functions
# each one launches: kernel 3 (hash_limbs) runs `digest_limbs_kernel` or, at
# other leaf widths, `digest_kernel<LimbSource>`, so kernels 2 and 3 are
# counted together.
KERNEL_FUNCTIONS = {
    "dft_level": "dft_level_kernel", "hash_words": "digest_kernel",
    "hash_limbs": "digest_kernel", "lcomb_tail": "lcomb_tail_kernel",
    "field_ew": "field_ew_kernel", "outer_table": "outer_table_kernel",
    "butterfly": "butterfly_kernel", "bfly_stage": "butterfly_stages_kernel",
    "bfly_stage_split": "butterfly_stages_kernel", "mont_inv": "mont_inv_kernel",
    "sample_queries": "sample_queries_kernel", "mont_chain": "mont_chain_kernel",
    "u32_chain": "u32_chain_kernel",
}

Interval = Tuple[int, int]


@dataclass
class Profile:
    requests: List[Interval]                  # bench.request ranges
    stages: Dict[str, List[Interval]]         # prove.* ranges by name
    device: List[Tuple[str, int, int]]        # (name, start, end) of each device op

    @classmethod
    def from_profiler(cls, prof) -> "Profile":
        from torch.autograd import DeviceType

        requests, stages, device = [], {s: [] for s in STAGES}, []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                # the profiler repeats the host ranges on the device's timeline
                if not (getattr(e, "is_user_annotation", lambda: False)() or name == REQUEST
                        or name in stages):
                    device.append((name, start, end))
            elif name == REQUEST:
                requests.append((start, end))
            elif name in stages:
                stages[name].append((start, end))
        requests.sort()
        device.sort(key=lambda d: d[1])
        return cls(requests, stages, device)

    @property
    def window(self) -> Interval:
        return self.requests[0][0], self.requests[-1][1]

    def busy_intervals(self) -> List[Interval]:
        """The union of device operations, clipped to the window."""
        w0, w1 = self.window
        merged: List[List[int]] = []
        for _, s, e in self.device:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.busy_intervals())

    def window_ns(self) -> int:
        w0, w1 = self.window
        return w1 - w0

    def stage_ms_per_request(self, names) -> float:
        total = sum(e - s for n in names for s, e in self.stages[n])
        return total / len(self.requests) / 1e6

    def top_device_ops(self, k: int = 10) -> List[list]:
        totals: Dict[str, int] = {}
        for name, s, e in self.device:
            short = (name[:name.rfind("(")] if name.endswith(")") else name)[:120]
            totals[short] = totals.get(short, 0) + (e - s)
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
        return [[name, ns / 1e9] for name, ns in ranked]

    def idle_by_host(self, k: int = 10) -> List[list]:
        """The device's idle seconds in the window, by the host range the
        idle time falls in: a prove stage, the rest of a request (the host
        trace, the assertion check, the serialization), or between requests."""
        gaps, at = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.window[1] > at:
            gaps.append((at, self.window[1]))
        labelled = [(s, e, n) for n, ivs in self.stages.items() for s, e in ivs]
        totals: Dict[str, int] = {}
        for g0, g1 in gaps:
            inside = 0
            for s, e, n in labelled:
                overlap = min(g1, e) - max(g0, s)
                if overlap > 0:
                    totals[n] = totals.get(n, 0) + overlap
                    inside += overlap
            in_request = sum(max(0, min(g1, e) - max(g0, s)) for s, e in self.requests)
            if in_request > inside:
                totals["request.other"] = totals.get("request.other", 0) + in_request - inside
            if g1 - g0 > in_request:
                totals["between_requests"] = totals.get("between_requests", 0) + (
                    g1 - g0 - in_request)
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
        return [[name, ns / 1e9] for name, ns in ranked]

    def kernel_counts(self) -> Dict[str, int]:
        """Device operations recorded per CUDA function of the port."""
        out = {}
        for fn in sorted(set(KERNEL_FUNCTIONS.values())):
            pattern = re.compile(rf"\b{fn}\b|\bdigest_limbs_kernel\b" if fn == "digest_kernel"
                                 else rf"\b{fn}\b")
            out[fn] = sum(1 for name, _, _ in self.device if pattern.search(name))
        return out


def launches_by_function(counts: Dict[str, int]) -> Dict[str, int]:
    """The port's launch counters summed per CUDA function."""
    out = {fn: 0 for fn in set(KERNEL_FUNCTIONS.values())}
    for key, n in counts.items():
        out[KERNEL_FUNCTIONS[key]] += n
    return dict(sorted(out.items()))
