"""Rank-side cases of tests/test_torch_parallel.py: each runs in a process
of a `gloo` group spawned by genstark_tpu_torch.parallel.launch.run_ranks,
imports only torch and the port, and returns plain data to the parent."""

import hashlib
import os
import random
import sys
import time
from types import SimpleNamespace

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TOY = {"extension_factor": 4, "exe_query_count": 8, "fri_query_count": 6}
# tests/test_sharded_prover.py's options
SHARDED_OPTS = {"extension_factor": 4, "exe_query_count": 10, "fri_query_count": 6}
# two FRI layers (Ne = 2048) for the layer that drops below the sharded size
FRI_DROP_OPTS = {"extension_factor": 16, "exe_query_count": 10, "fri_query_count": 6}
NTT_CASES = [(p_name, n) for p_name in ("P32", "P128") for n in (256, 1024)]


def prove_case(mesh, modulus, steps, use_input, count, options, seeds=(3,)):
    """MiMC over the mesh, or on the CPU alone where mesh is None (the
    test_sharded_prover.py statement: seed 3, the first and last control
    values asserted; each of `seeds` in turn on one Stark): (stark, the
    last proof's bytes, host fallbacks)."""
    from examples.mimc_torch import make_mimc_stark, run_mimc
    from genstark_tpu_torch.protocol import Assertion
    stark, constants = make_mimc_stark(steps, mesh.device if mesh is not None else "cpu",
                                       modulus=modulus, use_input=use_input,
                                       constant_count=count, options=options)
    if mesh is not None:
        stark.set_mesh(mesh)
    for seed in seeds:
        controls = run_mimc(stark.air.field, steps, constants, seed)
        assertions = [Assertion(0, 0, controls[0]), Assertion(steps - 1, 0, controls[-1])]
        proof = (stark.prove(assertions, [[seed]]) if use_input else
                 stark.prove(assertions, [], [seed]))
    return stark, stark.serialize(proof), sum(p.host_fallbacks for p in stark._provers.values())


def ntt_values(field, n: int):
    """tests/test_parallel.py's input: random.Random(n) values below p."""
    rng = random.Random(n)
    return [rng.randrange(field.modulus) for _ in range(n)]


def _ntt_cases(mesh):
    from genstark_tpu_torch import field as fields
    from genstark_tpu_torch import ntt
    from genstark_tpu_torch.parallel import distributed_intt, distributed_ntt
    from genstark_tpu_torch.parallel.distributed import fetch
    out = {}
    for p_name, n in NTT_CASES:
        f = fields.create_prime_field(getattr(fields, p_name))
        dev = f.device_field(mesh.device)
        x = dev.from_ints(ntt_values(f, n))
        off, b = mesh.block(n)
        got = distributed_ntt(f, x[:, off:off + b].contiguous(), mesh)
        full = torch.from_numpy(fetch(got, mesh, sharded=True))
        # the block layout D[k1, k2]: each rank's rows k1, gathered along -2
        rows = distributed_ntt(f, x[:, off:off + b].contiguous(), mesh, natural_output=False)
        d = torch.cat(mesh.all_gather(rows), dim=-2)
        out[(p_name, n)] = (bool(torch.equal(full, ntt.ntt(f, x))), dev.to_ints(full),
                            list(d.shape[-2:]), dev.to_ints(d.reshape(dev.L, n)))
    f = fields.create_prime_field(fields.P128)
    dev = f.device_field(mesh.device)
    vals = random.Random(7)
    vals = [vals.randrange(f.modulus) for _ in range(512)]
    x = dev.from_ints(vals)
    off, b = mesh.block(512)
    back = distributed_intt(f, distributed_ntt(f, x[:, off:off + b].contiguous(), mesh), mesh)
    out["roundtrip"] = dev.to_ints(torch.from_numpy(fetch(back, mesh, sharded=True))) == vals
    return out


def _halo_cases(mesh):
    """ShardedProver._next_evals against torch.roll of the whole domain,
    for shifts up to the block's length."""
    from genstark_tpu_torch.protocol.sharded import ShardedProver
    n = 64
    full = torch.arange(2 * 3 * n, dtype=torch.int32).reshape(2, 3, n)
    off, b = mesh.block(n)
    block = full[..., off:off + b]
    ok = {}
    for shift in (1, b // 2, b):
        got = ShardedProver._next_evals(SimpleNamespace(mesh=mesh), block, shift)
        ok[shift] = bool(torch.equal(got, torch.roll(full, -shift, dims=-1)[..., off:off + b]))
    return ok


def _fri_drop_case(mesh):
    """P32 MiMC at 128 steps, Ne = 2048: with FRI_SHARD_MIN_ROWS = 64 the
    first layer is sharded and the next falls below it on 4 ranks (on 2
    both are sharded and the remainder is gathered); power tables factored
    above 64 entries, so the ranks slice outer factors."""
    from genstark_tpu_torch.field import P32
    from genstark_tpu_torch.protocol import sharded
    saved = sharded.FRI_SHARD_MIN_ROWS
    sharded.FRI_SHARD_MIN_ROWS = 64
    sharded.ShardedProver._factor_threshold = 64
    try:
        stark, data, fallbacks = prove_case(mesh, P32, 128, False, 64, FRI_DROP_OPTS)
    finally:
        sharded.FRI_SHARD_MIN_ROWS = saved
        del sharded.ShardedProver._factor_threshold
    prover = next(iter(stark._provers.values()))
    tables = prover._get_tables()
    return {"bytes": data, "fallbacks": fallbacks, "fri_sharded": list(prover._fri_sharded),
            "factored": sorted(k for k, t in tables.items() if t[0] == "factored")}


def mesh_cases(mesh):
    """The cases whose code turns on the rank count (the 8-rank group's):
    the distributed NTT, the p128 pin (D <= T, the factored tables' blocks)
    and a FRI layer gathered below the sharded size; with the traffic of
    every collective."""
    from genstark_tpu_torch.field import P128
    t0 = time.monotonic()
    out = {"ntt": _ntt_cases(mesh)}
    _, data, fallbacks = prove_case(mesh, P128, 128, False, 64, SHARDED_OPTS)
    out["p128"] = {"bytes": data, "fallbacks": fallbacks}
    out["fri_drop"] = _fri_drop_case(mesh)
    out["traffic"] = dict(mesh.traffic)
    out["seconds"] = time.monotonic() - t0
    return out


def all_cases(mesh):
    """Every rank-side case of the module, one group."""
    from genstark_tpu_torch.field import P32, P64
    t0 = time.monotonic()
    out = mesh_cases(mesh)
    out["halo"] = _halo_cases(mesh)
    for label, args in (("p32", (P32, 128, False, 64, SHARDED_OPTS)),
                        ("p64", (P64, 64, True, 64, TOY))):
        _, data, fallbacks = prove_case(mesh, *args)
        out[label] = {"bytes": data, "fallbacks": fallbacks}
    # seed 5's statement after seed 3's: other values at the same steps
    stark, data, fallbacks = prove_case(mesh, P32, 128, False, 64, SHARDED_OPTS, (3, 5))
    out["p32_values"] = {"bytes": data, "fallbacks": fallbacks, "provers": len(stark._provers)}
    from genstark_tpu_torch.parallel import make_mesh
    from genstark_tpu_torch.parallel.distributed import fetch
    mine = torch.full((2, 5), mesh.rank, dtype=torch.int32)
    out["fetch"] = fetch(mine, mesh, sharded=True).tobytes()
    try:
        make_mesh(mesh.size + 1)
        out["make_mesh_raises"] = False
    except ValueError:
        out["make_mesh_raises"] = True
    out["traffic"] = dict(mesh.traffic)
    out["seconds"] = time.monotonic() - t0
    return out


def raise_on_rank(mesh, bad: int):
    """Rank `bad` raises; the others wait in a collective for it."""
    if mesh.rank == bad:
        raise ValueError(f"rank {bad} gives up")
    x = torch.ones(4)
    mesh.all_reduce_sum(x)
    return x


def sleep_on_rank(mesh, seconds: float):
    """Rank 0 outlives any short timeout; the others wait for it."""
    if mesh.rank == 0:
        time.sleep(seconds)
    x = torch.ones(4)
    mesh.all_reduce_sum(x)
    return x


def digest(data: bytes):
    return len(data), hashlib.sha256(data).hexdigest()
