"""The device mesh of the sharded prover: one rank per process, and the
collectives the port calls on it.

Counterpart of ``genstark_tpu/parallel/mesh.py`` (`make_mesh` :15).  The
JAX package is single-controller: one `jax.sharding.Mesh` over the local
devices, with GSPMD placing the collectives.  The port is SPMD, PyTorch's
idiom: every rank is a process of a `torch.distributed` group, holds the
contiguous block [rank n/D, (rank + 1) n/D) of every domain-major tensor of
n points, and calls each collective itself (parallel/ntt_dist.py,
protocol/sharded.py).  Only collectives that both `nccl` and `gloo` take on
CUDA tensors are used: `all_to_all_single`, list-form `all_gather` and
`all_reduce` (gloo takes CUDA tensors for all three, so no exchange is
staged through host memory by hand).  A mesh of one rank calls them too:
both backends take a collective in a one-rank group, so the one-rank NCCL
run drives every exchange of the sharded path on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import time

import torch
import torch.distributed as dist


@dataclass(eq=False)
class Mesh:
    """A 1-D mesh: the process group, its size D, this rank and its torch
    device.  `traffic` counts, per collective, this rank's calls, the bytes
    it sent and the host seconds it spent in them (each call blocks until
    its exchange is done, queued kernels before it included)."""
    group: object
    size: int
    rank: int
    device: torch.device
    backend: str
    traffic: dict = field(default_factory=dict)

    def block(self, n: int) -> tuple:
        """(first position, length) of this rank's block of n points."""
        if n % self.size:
            raise ValueError(f"{n} points do not split over {self.size} ranks")
        b = n // self.size
        return self.rank * b, b

    # ------------------------------------------------------------ collectives
    def _count(self, op: str, nbytes: int, t0: float) -> None:
        calls, sent, seconds = self.traffic.get(op, (0, 0, 0.0))
        self.traffic[op] = (calls + 1, sent + nbytes, seconds + time.monotonic() - t0)

    def all_to_all(self, x: torch.Tensor, in_splits: Optional[Sequence[int]] = None,
                   out_splits: Optional[Sequence[int]] = None) -> torch.Tensor:
        """`all_to_all_single` along dim 0 of x: equal blocks, or the rows
        per rank given by in_splits / out_splits (counted apart, as
        "all_to_all_single splits")."""
        t0 = time.monotonic()
        x = x.contiguous()
        rows = sum(out_splits) if out_splits is not None else x.shape[0]
        out = x.new_empty((rows,) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x, None if out_splits is None else list(out_splits),
                               None if in_splits is None else list(in_splits),
                               group=self.group)
        op = "all_to_all_single" if in_splits is None else "all_to_all_single splits"
        self._count(op, x.numel() * x.element_size(), t0)
        return out

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """List-form `all_gather`: every rank's x, in rank order."""
        t0 = time.monotonic()
        x = x.contiguous()
        outs = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(outs, x, group=self.group)
        self._count("all_gather", x.numel() * x.element_size(), t0)
        return outs

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """`all_reduce(SUM)` of a contiguous x, in place; returns x."""
        t0 = time.monotonic()
        dist.all_reduce(x, group=self.group)
        self._count("all_reduce", x.numel() * x.element_size(), t0)
        return x


def make_mesh(n_devices: Optional[int] = None, group=None, device=None) -> Mesh:
    """The mesh over the first `n_devices` ranks of `group` (the default
    group when None; every rank of it when n_devices is None), on `device`:
    by default the current CUDA device (the card `initialize` made
    current); the caller passes "cpu" for a group of CPU ranks.  Every rank
    of the group calls it.  Raises where the group has fewer ranks than
    asked, as the JAX `make_mesh` does, and on a rank outside the mesh."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized "
                           "(genstark_tpu_torch.parallel.distributed.initialize)")
    group = group or dist.group.WORLD
    world = dist.get_world_size(group)
    n = n_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} available")
    if n < world:
        group = dist.new_group([dist.get_global_rank(group, r) for r in range(n)])
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not one of the mesh's ranks")
    device = torch.device(device if device is not None else
                          f"cuda:{torch.cuda.current_device()}")
    return Mesh(group, n, rank, device, dist.get_backend(group))
