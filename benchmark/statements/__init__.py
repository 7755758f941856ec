"""Statement generators: plain code that makes, from `--seed`, the
statements a cell's proofs prove.  One module per AIR family, named by a
configuration's "statements" key; each has `make(config, traffic, seed,
index) -> Statement` and `trace_steps(config, traffic) -> int` (the
schema's base steps), and may have `make_all(config, traffic, seed,
count)` where making many together is cheaper.  They import nothing of the
program.
"""

from __future__ import annotations

import hashlib
import importlib
import multiprocessing
import os
from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class Statement:
    assertions: List[Tuple[int, int, int]]     # (step, register, value)
    inputs: list                                # per input register, nested
    public: list                                # per public input register, nested
    shapes: List[List[int]]                     # per input register


def module(name: str):
    return importlib.import_module(f"{__name__}.{name.replace('-', '_')}")


def draw(seed: int, index: int, label: str, modulus: int) -> int:
    """A field element drawn from (seed, statement index, label)."""
    data = f"{seed}:{index}:{label}".encode()
    return int.from_bytes(hashlib.sha256(data).digest() + hashlib.sha256(data + b"+").digest(),
                          "big") % modulus


_worker = {}


def init_worker(config: dict, traffic: dict, cpus) -> None:
    """Pool initializer: the configuration and mix a worker's statements
    use, and every CPU the machine gives."""
    try:
        os.sched_setaffinity(0, cpus)
    except OSError:            # the machine's CPUs as they are
        pass
    _worker.update(config=config, traffic=traffic, make=module(config["statements"]).make)


def make_in_worker(task) -> Statement:
    seed, index = task
    return _worker["make"](_worker["config"], _worker["traffic"], seed, index)


def make_all(config: dict, traffic: dict, seed: int, count: int) -> List[Statement]:
    """Statements 0 .. count - 1 of the seed: the family's `make_all`, or
    its `make` in worker processes."""
    family = module(config["statements"])
    if hasattr(family, "make_all"):
        return family.make_all(config, traffic, seed, count)
    cpus = os.sched_getaffinity(0) | set(range(os.cpu_count() or 1))
    workers = max(1, min(len(cpus) - 1, count, 7))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers, initializer=init_worker, initargs=(config, traffic, cpus)) as pool:
        out = pool.map(make_in_worker, [(seed, i) for i in range(count)],
                       chunksize=max(1, count // (4 * workers)))
        pool.close()
        pool.join()
    return out
