"""Process-group wiring for the sharded prover.

Counterpart of ``genstark_tpu/parallel/distributed.py`` (:40-83): the JAX
package joins a `jax.distributed` group and builds one global `Mesh`; the
port joins a `torch.distributed` group, one process a rank, and builds its
`parallel.mesh.Mesh` over every rank.  Nothing tells a program of a
cluster: the caller gives the init method, the world size and the rank.

Launch recipe, one process per card (D cards on one host, or across hosts
with a `tcp://` address every host reaches):

    torchrun --nproc-per-node D prove_job.py        # sets RANK, WORLD_SIZE

    # inside prove_job.py:
    import os
    from genstark_tpu_torch.parallel import distributed
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = distributed.initialize("nccl", rank, world,
                                    init_method="env://")  # torchrun's MASTER_ADDR/PORT
    stark.set_mesh(distributed.global_mesh(device))    # cuda:<rank mod cards>
    proof = stark.prove(assertions, inputs)        # the same bytes on every rank

Without torchrun, give every process the same `init_method`:
`tcp://<host>:<port>` (any free port on rank 0's host) or
`file:///<shared path>` (a file no earlier group used).  Ranks that share
one card run over `gloo` (NCCL refuses two ranks on one device);
`parallel/launch.py` spawns such a group on one host with a `FileStore`.
"""

from __future__ import annotations

import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

DEFAULT_TIMEOUT_S = 300.0


def initialize(backend: str, rank: int, world_size: int, init_method: Optional[str] = None,
               store=None, device: str = "cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join (or create) the process group: `init_process_group` with the
    caller's backend ("nccl" or "gloo"), an explicit timeout, and either
    `init_method` or a `store`.  Returns this rank's device: `device`
    "cuda" (the default, with either backend) is cuda:(rank mod the
    visible cards), any other name is taken as it is ("cpu" for CPU
    ranks).  A CUDA device is made current before the group is made, as
    NCCL needs."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: the port runs on nccl or gloo")
    if device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"backend": backend, "rank": rank, "world_size": world_size,
              "timeout": datetime.timedelta(seconds=timeout_s)}
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = init_method or "env://"
    dist.init_process_group(**kwargs)
    return dev


def global_mesh(device=None) -> Mesh:
    """The 1-D mesh over every rank of the default group, on `device` (the
    one `initialize` returned; the current CUDA device by default), ranks
    in group order, so rank r holds block r of every sharded tensor."""
    return make_mesh(device=device)


def fetch(x: torch.Tensor, mesh: Optional[Mesh] = None, sharded: bool = False) -> np.ndarray:
    """A device tensor as host numpy, the same bytes on every rank.  A
    replicated x is one transfer; a rank's block (`sharded`, along the last
    axis) is first `all_gather`ed from every rank, in rank order (the JAX
    `fetch`'s `process_allgather`, distributed.py:68-83): what keeps a
    host transcript identical everywhere."""
    if sharded and mesh is not None:
        x = torch.cat(mesh.all_gather(x), dim=-1)
    return x.cpu().numpy()


def shutdown() -> None:
    """Leave the process group (a no-op where none was made)."""
    if dist.is_initialized():
        dist.destroy_process_group()
