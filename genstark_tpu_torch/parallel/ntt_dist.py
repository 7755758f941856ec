"""Distributed four-step (Bailey) NTT over a 1-D mesh of ranks.

Counterpart of ``genstark_tpu/parallel/ntt_dist.py``: `can_distribute`
(:121-129), `_vector_power_series` (:33-49), `dist_ntt_core` (:132-210),
`distributed_ntt` / `distributed_intt` (:222-237); the `_dist_ntt_fn`
cache (:51-118) is a plan cache per (field, device, n, D, rank, direction).

n = n1 * n2, the values viewed as A[i1, i2] (position i1*n2 + i2):

  1. n1-point transforms along i1, on the rank's columns i2 (n2/D of them),
  2. the twiddle w^(k1*i2) on those columns (kernel-5 products),
  3. one `all_to_all_single`: split k1 over the ranks, gather every i2,
  4. n2-point transforms along i2, giving X[k1 + n1*k2] for the rank's k1.

The local transforms are the port's `ntt.transform` on plans of the local
sizes (kernel 1 for the solinas fields; kernel 8, or the four-step, for
the others), made by `ntt.make_plan` from the roots w^n2 and w^n1 (the
JAX package picks them out of the whole table instead, :169-171); the
first carries the plan's scale.

Layouts (`dist_transform`).  A rank's natural block is positions
[r n/D, (r + 1) n/D).  From replicated values (coefficients that came from
the host or an all_gather) step 1 reads the rank's columns with no
exchange; from a natural block it takes one more `all_to_all_single` first.
To give a natural block back, the result X[k1 + n1*k2] held by k1 goes
through a second `all_to_all_single` (the JAX package's natural-order
transpose, which GSPMD turns into a second reshard, :208-210); to give
replicated values back, one list-form `all_gather`.  So a sharded LDE from
replicated coefficients costs two exchanges, a block-to-block transform
(`distributed_ntt`) three, and an interpolation from a block to
replicated coefficients two exchanges and a gather.  Sizes where
`can_distribute` is false run whole on every rank, which keeps its block.
With `natural_output=False`, `distributed_ntt` / `distributed_intt` skip
the last exchange and give the rank's rows of the block layout D[k1, k2]
= X[k1 + n1*k2], the JAX functions' layout without their transpose.
"""

from __future__ import annotations

import torch

from ..field.limbs import power_series_mont_np
from ..ntt import make_plan, transform
from .mesh import Mesh


def can_distribute(n: int, n_devices: int) -> bool:
    """True when the four-step split of an n-point transform fits the mesh
    (both sub-transform axes at least the rank count)."""
    if n < 4:
        return False
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    return n1 >= n_devices and n2 >= n_devices


def _vector_power_series(dev, base: torch.Tensor, length: int) -> torch.Tensor:
    """Powers 0..length-1 of a vector of bases: [L, B] -> [L, length, B],
    by doubling (one kernel-5 product a doubling and one for the next
    multiplier)."""
    out = dev.one((1, 1)).expand(-1, 1, base.shape[-1])     # powers 0..cur-1
    power = base[:, None, :]                                 # base^cur
    cur = 1
    while cur < length:
        out = torch.cat([out, dev.mont_mul(out, power)], dim=1)
        if 2 * cur < length:
            power = dev.mont_mul(power, power)
        cur *= 2
    return out[:, :length]


class DistPlan:
    """One (field, n, root, scale) transform over a mesh of D ranks, seen
    from one rank: the local plans (n1 points, root w^n2, carrying the
    scale; n2 points, root w^n1) and the rank's twiddles w^(k1*i2) as
    [L, n2/D, n1]; or, where `can_distribute` is false, the whole n-point
    plan."""

    def __init__(self, field, dev, n: int, mesh: Mesh, root: int, scale: int = 1):
        p = field.modulus
        root %= p
        self.n = n
        self.D = mesh.size
        self.distributed = can_distribute(n, mesh.size)
        if not self.distributed:
            self.full = make_plan(field, dev, n, root, scale)
            return
        self.n1 = n1 = 1 << ((n.bit_length() - 1) // 2)
        self.n2 = n2 = n // n1
        self.p1 = make_plan(field, dev, n1, pow(root, n2, p), scale)
        self.p2 = make_plan(field, dev, n2, pow(root, n1, p), 1)
        c = n2 // mesh.size
        base = dev.from_numpy(power_series_mont_np(field.params, root, c, start=mesh.rank * c))
        self.tw = _vector_power_series(dev, base, n1).permute(0, 2, 1).contiguous()


def dist_transform(dev, x: torch.Tensor, plan: DistPlan, mesh: Mesh,
                   inp: str = "replicated", out: str = "block") -> torch.Tensor:
    """The plan's transform of x [..., L, m] over the mesh, natural order
    in and out.  inp "replicated": x holds the first m <= n values of the
    input (zeros above, an LDE's padding) on every rank; "block": x is the
    rank's natural block (m = n/D).  out "block": the rank's natural block
    [..., L, n/D] of the result; "replicated": the whole [..., L, n];
    "rows": the rank's rows k1 in [r n1/D, (r + 1) n1/D) of the four-step's
    output D[k1, k2] = X[k1 + n1 k2], [..., L, n1/D, n2] (no exchange after
    the second transform)."""
    n, D, r = plan.n, mesh.size, mesh.rank
    batch, L = tuple(x.shape[:-2]), x.shape[-2]
    x = x.reshape((-1, L, x.shape[-1]))
    B = x.shape[0]
    if out == "rows" and not plan.distributed:
        raise ValueError(f"domain {n} too small for {D} devices")
    if not plan.distributed:
        if inp == "block":
            x = torch.cat(mesh.all_gather(x), dim=-1)
        y = transform(dev, torch.nn.functional.pad(x, (0, n - x.shape[-1])), plan.full)
        if out == "block":
            off, b = mesh.block(n)
            y = y[..., off:off + b].contiguous()
        return y.reshape(batch + (L, y.shape[-1]))

    n1, n2 = plan.n1, plan.n2
    a, c = n1 // D, n2 // D
    if inp == "replicated":
        src = x.shape[-1]
        rows = -(-src // n2)
        x = torch.nn.functional.pad(x, (0, rows * n2 - src)).reshape(B, L, rows, n2)
        cols = x[..., r * c:(r + 1) * c].permute(0, 3, 1, 2)            # [B, c, L, rows]
        cols = torch.nn.functional.pad(cols, (0, n1 - rows)).contiguous()
    else:
        # natural block: rows i1 in [r a, (r + 1) a), every i2
        send = x.reshape(B, L, a, D, c).permute(3, 0, 1, 2, 4)          # [dest, B, L, a, c]
        got = mesh.all_to_all(send)                                      # [src, B, L, a, c]
        cols = got.permute(1, 4, 2, 0, 3).reshape(B, c, L, n1)
    y = transform(dev, cols, plan.p1)                                    # [B, c, L, n1]: k1
    y = dev.mont_mul(y.permute(2, 0, 1, 3), plan.tw)                     # [L, B, c, n1]
    send = y.reshape(L, B, c, D, a).permute(3, 1, 4, 0, 2)               # [dest, B, a, L, c]
    got = mesh.all_to_all(send)                                          # [src, B, a, L, c]
    z = transform(dev, got.permute(1, 2, 3, 0, 4).reshape(B, a, L, n2), plan.p2)
    # z[b, k1 - r a, :, k2] = X[k1 + n1 k2]
    if out == "rows":
        return z.permute(0, 2, 1, 3).reshape(batch + (L, a, n2))
    if out == "block":
        send = z.reshape(B, a, L, D, c).permute(3, 0, 1, 2, 4)          # [dest, B, a, L, c]
        got = mesh.all_to_all(send)                                      # [src, B, a, L, c]
        y = got.permute(1, 3, 4, 0, 2).reshape(B, L, n // D)             # k1 + n1 k2_local
    else:
        full = torch.stack(mesh.all_gather(z), dim=1).reshape(B, n1, L, n2)
        y = full.permute(0, 2, 3, 1).reshape(B, L, n)
    return y.reshape(batch + (L, y.shape[-1]))


_PLANS = {}


def _plan(field, dev, n: int, mesh: Mesh, inverse: bool) -> DistPlan:
    key = (field.modulus, str(dev.device), n, mesh.size, mesh.rank, inverse)
    plan = _PLANS.get(key)
    if plan is None:
        f = field.host
        root = f.get_root_of_unity(n)
        if inverse:
            plan = DistPlan(field, dev, n, mesh, f.inv(root), f.inv(n % field.modulus))
        else:
            plan = DistPlan(field, dev, n, mesh, root)
        _PLANS[key] = plan
    return plan


def distributed_ntt(field, values: torch.Tensor, mesh: Mesh,
                    natural_output: bool = True) -> torch.Tensor:
    """Forward NTT over the mesh: values [..., L, n/D] is this rank's
    natural block of the n-point input (Montgomery limbs on the mesh's
    device); returns its block of the output, which `distributed.fetch(...,
    sharded=True)` gathers into the JAX `distributed_ntt`'s global array.
    natural_output=False: the rank's rows [..., L, n1/D, n2] of the block
    layout D[k1, k2] = X[k1 + n1*k2] (gathered along axis -2, the JAX
    function's [L, n1, n2] output); it raises where the mesh cannot split n."""
    return _distributed(field, values, mesh, False, natural_output)


def distributed_intt(field, values: torch.Tensor, mesh: Mesh,
                     natural_output: bool = True) -> torch.Tensor:
    """Inverse NTT over the mesh (n^-1 folded), block in; out as
    `distributed_ntt`'s."""
    return _distributed(field, values, mesh, True, natural_output)


def _distributed(field, values, mesh: Mesh, inverse: bool, natural_output: bool):
    n = values.shape[-1] * mesh.size
    dev = field.device_field(values.device)
    return dist_transform(dev, values, _plan(field, dev, n, mesh, inverse), mesh, "block",
                          "block" if natural_output else "rows")
