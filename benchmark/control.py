"""The readings that set `correct`'s limits, at a cell's own sizes.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 --requests 4

For each seed, `--requests` statements are proved by the port as the
configuration states (the sound readings) and by the control, the port
with one query fewer of each kind (the step a later change would be
tempted by: fewer queries, a faster prove, a weaker guarantee than the
configuration states).  The plain reference judges every proof, and two
faults planted where a proof is produced: one byte of a sound proof
altered, and a request answered with the previous request's proof (a
state returned unchanged).  One JSON line a seed gives the count of
rejected proofs of each kind.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import random
import sys

from . import cells, program, statements
from .reference.air import Air, schema_of
from .reference.verifier import Reject, verify


def control_options(options: dict) -> dict:
    out = dict(options)
    out["exe_query_count"] -= 1
    out["fri_query_count"] -= 1
    return out


def altered(data: bytes, rng: random.Random) -> bytes:
    """One byte of the proof changed, at an offset drawn from `rng`."""
    out = bytearray(data)
    at = rng.randrange(len(out))
    out[at] ^= 1 + rng.randrange(255)
    return bytes(out)


def readings(cell: cells.Cell, seed: int, requests: int, device: str = "cuda") -> dict:
    config, traffic = cell.config, cell.traffic
    made = statements.make_all(config, traffic, seed, requests)
    air = Air(schema_of(config), config["field"]["modulus"],
              statements.module(config["statements"]).trace_steps(config, traffic))
    sound = program.build_stark(config, traffic, device)
    control = program.build_stark(config, traffic, device, control_options(config["options"]))
    rng = random.Random(seed)

    def rejected(statement, data) -> int:
        try:
            verify(air, config["options"], statement, data)
            return 0
        except Reject:
            return 1

    counts = {"requests": requests, "sound": 0, "control": 0, "altered": 0, "stale": 0}
    previous = None
    for st in made:
        a = program.assertions(st)
        data = program.prove(sound, st, a)
        counts["sound"] += rejected(st, data)
        counts["control"] += rejected(st, program.prove(control, st, a))
        counts["altered"] += rejected(st, altered(data, rng))
        if previous is not None:
            counts["stale"] += rejected(st, previous)
        previous = data
    counts["stale_of"] = requests - 1
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--requests", type=int, default=4)
    args = parser.parse_args(argv)
    cell = cells.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(cell, seed, args.requests)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
