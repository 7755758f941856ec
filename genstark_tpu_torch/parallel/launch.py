"""Spawn a group of ranks on one host and collect their results.

Counterpart of the parent and child halves of ``scripts/dist_dryrun.py``
(the JAX package's two OS processes over Gloo).  `run_ranks` starts D
processes with torch.multiprocessing (spawn), joins them into one
`torch.distributed` group through a `FileStore` in a fresh temporary
directory (so it needs no port), calls `fn(mesh, *args)` on every rank and
returns each rank's result to the parent, in rank order.  A rank that
raises, dies or outlives `timeout_s` makes it kill every rank and raise:
it is the only guard against a hung collective.

    from genstark_tpu_torch.parallel.launch import run_ranks
    proofs = run_ranks(prove_on_mesh, 4, "gloo", "cuda", args=(steps,), timeout_s=120)

(ranks 0-3 share the one card of a one-card host; "cpu" runs them on the
host's CPU).

`fn` must be importable by name (a module-level function); it returns
plain picklable data (tensors come back as numpy arrays).
"""

from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Sequence

import torch
import torch.multiprocessing as mp


class RankError(RuntimeError):
    """A rank raised, died without a result, or outlived its timeout."""


def _plain(x):
    """Tensors (on any device) as numpy arrays, through lists, tuples and
    dicts: what a rank returns crosses the process boundary by value."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _rank_main(rank, world, backend, device, store_path, fn, args, results, timeout_s,
               threads):
    from . import distributed
    from .mesh import make_mesh
    try:
        if threads:
            torch.set_num_threads(threads)
        store = torch.distributed.FileStore(store_path, world)
        dev = distributed.initialize(backend, rank, world, store=store, device=device,
                                     timeout_s=timeout_s)
        out = fn(make_mesh(device=dev), *args)
        results.put((rank, "ok", _plain(out)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    distributed.shutdown()


def run_ranks(fn: Callable, world: int, backend: str = "gloo", device: str = "cuda",
              args: Sequence = (), timeout_s: float = 120.0,
              threads: int = None) -> List[object]:
    """fn(mesh, *args) on each of `world` spawned ranks over `backend`, each
    on the device `distributed.initialize` gives it for `device` ("cuda":
    cuda:(rank mod the visible cards), so ranks share the card of a
    one-card host; "cpu" for CPU ranks); returns [result of rank 0, ...].
    Raises RankError, after killing every rank, when a rank raises or exits
    without a result, or when the group has not finished `timeout_s`
    seconds after the spawn (the group's own collective timeout is the
    same).  `threads`: torch's thread count in each rank."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="genstark_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, device, os.path.join(tmp, "store"), fn,
                               tuple(args), results, timeout_s, threads))
             for r in range(world)]
    got = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RankError(f"ranks {sorted(set(range(world)) - set(got))} of {world} did "
                                f"not finish within {timeout_s} s")
            try:
                rank, status, payload = results.get(timeout=min(0.5, left))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                if dead:
                    try:      # a result may still be in the pipe
                        rank, status, payload = results.get(timeout=2.0)
                    except queue_mod.Empty:
                        raise RankError(f"rank {dead[0]} exited with code "
                                        f"{procs[dead[0]].exitcode} without a result") from None
                else:
                    continue
            if status == "error":
                raise RankError(f"rank {rank} of {world} raised:\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world)]
