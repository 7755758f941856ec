"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up makes the cell's statements from the
seed with plain code, builds the port's Stark for the configuration and
proves warm-up statements.  The window is a closed loop
of one client: each request proves a statement no earlier request of the
run proved (`Stark.prove`, then `Stark.serialize`; it ends with the
proof's bytes on the host), until `--seconds` have passed.  After it: the
peak device memory, the port's own verify of the first proofs (the verify
phase), with `--trace 1` the per-layer readers, then the plain reference
judges a sample of the window's proofs, drawn from the seed.  The last
line of standard output is the result as one JSON object; the numbers
that decide `correct` are the last lines of standard error.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from . import cells, statements  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "genstark_tpu")


class NoDevice(Exception):
    """The machine lacks the cards the cell asks for."""


@dataclass
class Run:
    """What a window left behind, for the metric readers."""
    seed: int
    device: str
    device_kind: str = ""
    trace_length: int = 0
    evaluation_domain_size: int = 0
    attempted: int = 0
    completed: int = 0
    durations: List[float] = field(default_factory=list)
    trace_seconds: List[Optional[float]] = field(default_factory=list)
    window_s: float = 0.0
    setup_s: float = 0.0
    peak_bytes: Optional[int] = None
    request_peaks: List[int] = field(default_factory=list)
    launch_delta: Optional[Dict[str, int]] = None
    profile: object = None
    stark: object = None


def forbidden_modules() -> List[str]:
    """Top-level module names of JAX or the JAX package in this process."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _card(chips: int, device: str) -> str:
    import torch
    if device != "cuda":
        return "cpu"
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} CUDA device(s); "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    return torch.cuda.get_device_name(0)


def _power_limit(log) -> None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        log(f"nvidia-smi: {out.stdout.strip()}")
    except (OSError, subprocess.SubprocessError) as error:
        log(f"nvidia-smi: not read ({error})")


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float = None, log=None) -> dict:
    """One run of the cell; returns the result object.  `device` "cpu"
    drives the same path without a card (tests only)."""
    t0 = _T0 if t0 is None else t0
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    config, traffic = cell.config, cell.traffic
    kind = _card(cell.workload["chips"], device)
    import torch

    from . import program
    from .reference.air import Air, schema_of
    from .reference.verifier import Reject, verify as reference_verify
    if device == "cuda":
        _power_limit(log)

    # ----- set-up
    warmup = traffic["warmup"]
    made = statements.make_all(config, traffic, seed, warmup + traffic["statements"])
    log(f"setup: {len(made)} statements made in {time.perf_counter() - t0:.3f} s")
    stark = program.build_stark(config, traffic, device)
    pairs = [(st, program.assertions(st)) for st in made]
    for st, a in pairs[:warmup]:
        data = program.prove(stark, st, a)
        program.verify(stark, st, a, data)
    window = pairs[warmup:]
    # the harness's own objects stay out of the collector's way in the window
    gc.collect()
    gc.freeze()
    run = Run(seed=seed, device=device, device_kind=kind)
    run.trace_length = stark.last_context.trace_length
    run.evaluation_domain_size = stark.last_context.evaluation_domain_size

    from genstark_tpu_torch import kernels
    traced = traffic["traced_requests"] if trace else 0
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=activities)
        prof.start()
    if device == "cuda":
        torch.cuda.synchronize()
        run.peak_bytes = torch.cuda.max_memory_allocated()      # set-up's
    launches_before = dict(kernels.launch_counts)
    launches_traced = None

    # ----- the window
    from torch.profiler import record_function
    proofs, failed = [], set()
    start = time.perf_counter()
    run.setup_s = start - t0
    deadline = start + seconds
    end = start
    for i, (st, a) in enumerate(window):
        if time.perf_counter() >= deadline:
            break
        run.attempted += 1
        if device == "cuda":      # each request's own peak, over what was held when it began
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        try:
            if i < traced:
                with record_function("bench.request"):
                    data = program.prove(stark, st, a)
            else:
                data = program.prove(stark, st, a)
        except Exception as error:       # a failed request: counted, and the loop goes on
            data = None
            failed.add(i)
            log(f"request {i} raised {type(error).__name__}: {error}")
        end = time.perf_counter()
        if device == "cuda":
            top = torch.cuda.max_memory_allocated()
            run.peak_bytes = max(run.peak_bytes, top)
            run.request_peaks.append(top - held)
        if data is None:
            continue
        run.durations.append(end - t1)
        run.trace_seconds.append(stark.last_context.trace_seconds)
        proofs.append((i, data))
        if prof is not None and i + 1 == traced:
            if device == "cuda":
                torch.cuda.synchronize()
            prof.stop()
            launches_traced = {k: v - launches_before[k] for k, v in kernels.launch_counts.items()}
            prof_requests = i + 1
    else:
        if run.attempted == len(window):
            log(f"window: every one of the {len(window)} statements was proved after "
                f"{time.perf_counter() - start:.3f} s; the window ends early")
    run.window_s = end - start
    run.completed = len(proofs)
    run.launch_delta = {k: v - launches_before[k] for k, v in kernels.launch_counts.items()}
    if prof is not None and launches_traced is None:
        prof.stop()
        launches_traced = dict(run.launch_delta)
        prof_requests = run.attempted
    log(f"window: {run.attempted} attempted, {run.completed} completed in {run.window_s:.6f} s")
    if len(run.durations) >= 8:
        q = len(run.durations) // 4
        log("window: median request s by quarter " + json.dumps(
            [statistics.median(run.durations[k * q:(k + 1) * q]) for k in range(4)]))

    # ----- the verify phase: the port's parse + verify of the first proofs,
    # with the prover's kept objects out of the collector's way.  Each
    # proof's time goes to standard error: no metric (PERF.md, section 2)
    gc.collect()
    gc.freeze()
    port_rejected, verify_ms = set(), []
    for i, data in proofs[:traffic["verify_count"]]:
        st, a = window[i]
        t1 = time.perf_counter()
        try:
            if not program.verify(stark, st, a, data):
                port_rejected.add(i)
        except Exception as error:       # a rejected proof raises
            port_rejected.add(i)
            log(f"port verify of request {i}: {type(error).__name__}: {error}")
        verify_ms.append(round((time.perf_counter() - t1) * 1e3, 3))
    if verify_ms:
        log(f"verify phase: {len(verify_ms)} proofs in {sum(verify_ms):.3f} ms, "
            f"ms a proof {json.dumps(verify_ms)}")

    # ----- metrics
    breakdown = None
    if prof is not None:
        from .trace import Profile, launches_by_function
        run.profile = Profile.from_profiler(prof)
        log("profiler kernel counts against launch counters over the traced requests: "
            + json.dumps({"requests": prof_requests,
                          "profiler": run.profile.kernel_counts(),
                          "launch_counts": launches_by_function(launches_traced)}))
        if run.profile.device:
            breakdown = {"device_ops": run.profile.top_device_ops(),
                         "idle_gaps": run.profile.idle_by_host()}
    run.stark = stark
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
                   "count": cell.workload["chips"], "memory_peak_bytes": run.peak_bytes}
    if trace and run.profile is not None and run.profile.requests:
        device_info["busy_s"] = run.profile.busy_ns() / 1e9
        device_info["window_s"] = run.profile.window_ns() / 1e9

    # ----- the program's state goes; the plain reference judges a sample
    run.stark = stark = None
    del prof
    gc.unfreeze()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    air = Air(schema_of(config), config["field"]["modulus"],
              statements.module(config["statements"]).trace_steps(config, traffic))
    sample = random.Random(seed).sample(proofs, min(traffic["check_count"], len(proofs)))
    ref_rejected = set()
    t1 = time.perf_counter()
    for i, data in sample:
        try:
            reference_verify(air, config["options"], window[i][0], data)
        except Reject as error:
            ref_rejected.add(i)
            log(f"reference rejects request {i}: {error}")
    log(f"reference: {len(sample)} proofs judged in {time.perf_counter() - t1:.3f} s")

    checks = {
        "prove_errors": {"value": len(failed), "limit": 0},
        "port_rejected": {"value": len(port_rejected), "limit": 0},
        "ref_rejected": {"value": len(ref_rejected), "limit": 0},
        "ref_unjudged": {"value": min(traffic["check_count"], max(run.completed, 1)) - len(sample),
                         "limit": 0},
    }
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": run.attempted,
              "failed": len(failed | port_rejected | ref_rejected),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def pin_cpus() -> None:
    """The run and every thread it starts keep to two of the CPUs the
    process may use (the third and fourth): runs of this host-bound program
    on more of them spread more (PERF.md, section 2).  Statement workers
    take all of them back (`statements.init_worker`)."""
    allowed = sorted(os.sched_getaffinity(0))
    if len(allowed) >= 4:
        os.sched_setaffinity(0, allowed[2:4])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    pin_cpus()
    try:
        import genstark_tpu_torch  # noqa: F401
    except ImportError as error:
        print(f"the program under test is missing: {error}", file=sys.stderr)
        return 5
    cell = cells.cell(args.workload)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except NoDevice as error:
        print(str(error), file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
