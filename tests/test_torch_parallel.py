"""The port's sharded prover on the CPU: groups of `gloo` ranks spawned by
genstark_tpu_torch.parallel.launch.run_ranks (a FileStore, no port), one
4-rank, one 2-rank and one 1-rank group running every rank-side case
(tests/torch_parallel_cases.py), and one 8-rank group (the JAX pins' mesh
size) running the cases whose code turns on the rank count, against the
port's single-device proofs, the JAX package's proofs and `distributed_ntt`
outputs (on the conftest's 8-device mesh), pinned as digests that the `slow`
tests remake, and both verifiers.  Exact comparisons.  The groups run in
threads; each has its own timeout."""

import concurrent.futures
import hashlib
import json
import os
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_cases as cases  # noqa: E402

from genstark_tpu_torch.field import P32, P128  # noqa: E402
from genstark_tpu_torch.parallel import can_distribute  # noqa: E402
from genstark_tpu_torch.parallel.launch import RankError, run_ranks  # noqa: E402
from genstark_tpu_torch.testing import P64_64_PIN  # noqa: E402

# Far above the groups' ~15 s of work (a loaded test machine slows the
# spawn): a timeout only fires on a hang.
GROUP_TIMEOUT_S = 300.0
RAISE_TIMEOUT_S = 120.0
# tests/test_sharded_prover.py's pin of the JAX package's p128 proof
P128_SHARDED_PIN = (8119, "ea2c42e4b7fe34724f94d38b8c9452528df43f9946096fd6eda61bbf13740d9f")
# The JAX package's single-device p32 proofs at test_sharded_prover.py's
# configuration: seed 3, and seed 5 on a Stark that proved seed 3 first.
JAX_P32_PIN = (4883, "9fef8665e2517422b03413a8a290c8189dc049f8253e2ba260d7f1d7eac3ff7b")
JAX_P32_VALUES_PIN = (5656, "9d99a44446ea42a394cf7b86900e9a5d107e4b5965520b45ae81b9aa36097d94")
# sha256 (`_ntt_digest`) of the JAX distributed_ntt's outputs on the
# 8-device mesh, each case of NTT_CASES: the natural output, and the block
# layout's shape and rows (natural_output=False).
JAX_NTT_PINS = {
    ("P32", 256): "1d574b0db4bb8d9c3b62b74595770697571f37a68bdaf949dc083421fbee5b9d",
    ("P32", 1024): "7b848fae7ba6fe6a73ffa413a17cbfe0b573f4066df996e0b77f7f55899c0e1e",
    ("P128", 256): "173dca2fd4f7728e0e6a401a5b11903cea73509e266252e6ca86a242889fdd9d",
    ("P128", 1024): "bd3c71c69ae51ede800947710c9cb8339c6fc37995b0cdb3b40e7f4afbe63f06",
}


def _ntt_digest(ints, d_shape, d_ints) -> str:
    return hashlib.sha256(json.dumps([ints, d_shape, d_ints]).encode()).hexdigest()


def _timed(fn, *args):
    """(result or None, exception or None, seconds) of fn(*args)."""
    t0 = time.monotonic()
    try:
        return fn(*args), None, time.monotonic() - t0
    except Exception as exc:  # noqa: BLE001 - the tests look at it
        return None, exc, time.monotonic() - t0


@pytest.fixture(scope="module")
def groups():
    """Every spawned group at once, in threads: 4, 2 and 1 ranks over every
    case, 8 ranks over `mesh_cases`, a rank that raises, and a rank that
    outlives an 8 s timeout.  Read every future: its exception is raised
    where it is read."""
    pool = concurrent.futures.ThreadPoolExecutor(6)
    futures = {
        8: pool.submit(_timed, run_ranks, cases.mesh_cases, 8, "gloo", "cpu", (),
                       GROUP_TIMEOUT_S, 1),
        4: pool.submit(_timed, run_ranks, cases.all_cases, 4, "gloo", "cpu", (),
                       GROUP_TIMEOUT_S, 1),
        2: pool.submit(_timed, run_ranks, cases.all_cases, 2, "gloo", "cpu", (),
                       GROUP_TIMEOUT_S, 1),
        1: pool.submit(_timed, run_ranks, cases.all_cases, 1, "gloo", "cpu", (),
                       GROUP_TIMEOUT_S, 1),
        "raise": pool.submit(_timed, run_ranks, cases.raise_on_rank, 2, "gloo", "cpu", (1,),
                             RAISE_TIMEOUT_S, 1),
        "sleep": pool.submit(_timed, run_ranks, cases.sleep_on_rank, 2, "gloo", "cpu",
                             (120.0,), 8.0, 1),
    }
    yield futures
    pool.shutdown()


def _ranks(groups, world):
    results, exc, _ = groups[world].result()
    if exc is not None:
        raise exc
    assert len(results) == world
    return results


@pytest.fixture(scope="module")
def single():
    """The port's single-device proofs on the CPU (one torch thread)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {label: cases.prove_case(None, *args)[1] for label, args in (
            ("p32", (P32, 128, False, 64, cases.SHARDED_OPTS)),
            ("fri_drop", (P32, 128, False, 64, cases.FRI_DROP_OPTS)),
            ("p32_values", (P32, 128, False, 64, cases.SHARDED_OPTS, (5,))),
            ("p128_input_values", (P128, 64, True, 16, cases.TOY, (5,))))}
    finally:
        torch.set_num_threads(saved)


def _jax_ntt():
    """The JAX `distributed_ntt` on the 8-device mesh: {case: _ntt_digest}."""
    import jax
    from genstark_tpu.field import create_prime_field as jax_field
    from genstark_tpu import field as jax_fields
    from genstark_tpu.parallel import distributed_ntt, make_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    mesh = make_mesh(8)
    out = {}
    for p_name, n in cases.NTT_CASES:
        f = jax_field(getattr(jax_fields, p_name))
        x = f.device.from_ints(cases.ntt_values(f, n))
        d = distributed_ntt(f, x, mesh, natural_output=False)
        out[(p_name, n)] = _ntt_digest(f.device.to_ints(distributed_ntt(f, x, mesh)),
                                       list(d.shape[1:]),
                                       f.device.to_ints(d.reshape(f.device.L, n)))
    return out


@pytest.mark.slow
def test_distributed_ntt_pins_are_the_jax_packages():
    """The JAX distributed_ntt gives JAX_NTT_PINS."""
    assert _jax_ntt() == JAX_NTT_PINS


@pytest.mark.parametrize("world", [8, 4, 2, 1])
@pytest.mark.parametrize("case", cases.NTT_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_distributed_ntt_matches_single_and_jax(groups, world, case):
    """(a) every rank's gathered output equals the port's single-device
    ntt, and the JAX distributed_ntt; with natural_output=False the ranks'
    rows of the block layout D[k1, k2] equal the JAX function's
    (JAX_NTT_PINS)."""
    for rank in _ranks(groups, world):
        equal_single, ints, d_shape, d_ints = rank["ntt"][case]
        assert equal_single
        assert _ntt_digest(ints, d_shape, d_ints) == JAX_NTT_PINS[case]


@pytest.mark.parametrize("world", [4, 2, 1])
def test_distributed_intt_roundtrip(groups, world):
    """(b) intt(ntt(x)) == x at 512 points (tests/test_parallel.py:31)."""
    assert all(rank["ntt"]["roundtrip"] for rank in _ranks(groups, world))


@pytest.mark.parametrize("n", [2, 4, 8, 16, 64, 1 << 17])
@pytest.mark.parametrize("devices", [1, 4, 8])
def test_can_distribute_matches_jax(n, devices):
    """(c) the split rule equals the JAX function's."""
    from genstark_tpu.parallel.ntt_dist import can_distribute as jax_can_distribute
    assert can_distribute(n, devices) == jax_can_distribute(n, devices)


def _jax_p32():
    """The JAX package's p32 MiMC Stark at the sharded configuration, and
    the assertions of a seed on it."""
    from examples.mimc import make_mimc_stark as jax_make_mimc_stark
    from examples.mimc import run_mimc as jax_run_mimc
    from genstark_tpu.protocol import Assertion as JaxAssertion
    stark, constants = jax_make_mimc_stark(128, modulus=P32, use_input=False, constant_count=64,
                                           options=cases.SHARDED_OPTS)

    def assertions(seed):
        controls = jax_run_mimc(stark.air.field, 128, constants, seed)
        return [JaxAssertion(0, 0, controls[0]), JaxAssertion(127, 0, controls[-1])]
    return stark, assertions


@pytest.mark.slow
def test_jax_p32_pins_are_the_jax_packages():
    """One JAX Stark proves seed 3, then seed 5: JAX_P32_PIN, then
    JAX_P32_VALUES_PIN (its structure-keyed prover cache)."""
    stark, assertions = _jax_p32()
    got = [cases.digest(stark.serialize(stark.prove(assertions(seed), [], [seed])))
           for seed in (3, 5)]
    assert got == [JAX_P32_PIN, JAX_P32_VALUES_PIN]


@pytest.mark.parametrize("world", [4, 2, 1])
def test_sharded_p32_equals_single_and_jax(groups, single, world):
    """(d) the sharded p32 proof at test_sharded_prover.py's configuration
    equals the port's and the JAX package's single-device proof
    (JAX_P32_PIN), with no host-sampled fallback; the port's and the JAX
    package's verifiers accept it."""
    from examples.mimc_torch import make_mimc_stark
    from genstark_tpu_torch.protocol import Assertion
    ranks = _ranks(groups, world)
    data = ranks[0]["p32"]["bytes"]
    assert all(r["p32"]["bytes"] == data and r["p32"]["fallbacks"] == 0 for r in ranks)
    assert data == single["p32"]
    assert cases.digest(data) == JAX_P32_PIN
    stark, assertions = _jax_p32()
    jassert = assertions(3)
    assert stark.verify(jassert, stark.parse(data))
    port, _ = make_mimc_stark(128, "cpu", modulus=P32, use_input=False, constant_count=64,
                              options=cases.SHARDED_OPTS)
    assert port.verify([Assertion(a.step, a.register, a.value) for a in jassert],
                       port.parse(data))


@pytest.mark.parametrize("world", [4, 2, 1])
def test_sharded_new_values_reuse_the_prover(groups, single, world):
    """A second p32 statement, other values at the same steps, on the Stark
    that proved the first: one ShardedProver, and every rank's bytes are
    the single-device proof of that statement alone and the JAX package's
    proof of it after the first (JAX_P32_VALUES_PIN)."""
    for rank in _ranks(groups, world):
        got = rank["p32_values"]
        assert (got["provers"], got["fallbacks"]) == (1, 0)
        assert got["bytes"] == single["p32_values"] != single["p32"]
        assert cases.digest(got["bytes"]) == JAX_P32_VALUES_PIN


@pytest.mark.parametrize("world", [4, 2, 1])
def test_sharded_secret_input_after_another(groups, single, world):
    """A p128 MiMC statement with a secret input, proved over the mesh on
    the Stark that proved another first: one ShardedProver (the input
    register expanded on every rank from its value, the cyclic register's
    block of evaluations kept), and every rank's bytes are the
    single-device proof of that statement alone."""
    for rank in _ranks(groups, world):
        got = rank["p128_input_values"]
        assert (got["provers"], got["fallbacks"]) == (1, 0)
        assert got["bytes"] == single["p128_input_values"]


@pytest.mark.parametrize("world", [4, 2, 1])
def test_sharded_prover_never_replays(groups, world):
    """A ShardedProver records no CUDA graph (its transforms and trees call
    collectives): its class says so, and no prove of any rank replayed one."""
    for rank in _ranks(groups, world):
        assert rank["graphs"] == {"replays": 0, "provers": [("ShardedProver", False)]}


@pytest.mark.parametrize("world", [8, 4, 2, 1])
def test_sharded_p128_equals_jax_pin(groups, world):
    """(e) the sharded p128 proof is the JAX package's pinned bytes
    (tests/test_sharded_prover.py:73-74) on every rank."""
    for rank in _ranks(groups, world):
        assert cases.digest(rank["p128"]["bytes"]) == P128_SHARDED_PIN
        assert rank["p128"]["fallbacks"] == 0


@pytest.mark.parametrize("world", [4, 2, 1])
def test_sharded_p64_secret_input_equals_pin(groups, world):
    """(f) P64, the toy options, 64 steps, a secret input register: the
    radix-2 route, equal to P64_64_PIN on every rank."""
    for rank in _ranks(groups, world):
        assert cases.digest(rank["p64"]["bytes"]) == P64_64_PIN
        assert rank["p64"]["fallbacks"] == 0


@pytest.mark.parametrize("world", [4, 2, 1])
def test_halo_roll_across_blocks(groups, world):
    """(g) the roll by one trace step across block boundaries (the halo),
    shifts up to a whole block."""
    for rank in _ranks(groups, world):
        assert rank["halo"] and all(rank["halo"].values()), rank["halo"]


@pytest.mark.parametrize("world", [8, 4, 2, 1])
def test_fri_layer_below_sharded_size(groups, single, world):
    """(g) a FRI layer that falls below the sharded size is gathered and
    the proof is the single-device one; the ranks took their blocks of
    factored tables (outer-factor rows).  A layer of n points is sharded
    while (n / 4) / D >= 64 rows (layers 2048 and 512)."""
    want_sharded = {8: [True, False, False], 4: [True, False, False],
                    2: [True, True, False], 1: [True, True, False]}[world]
    for rank in _ranks(groups, world):
        case = rank["fri_drop"]
        assert case["fri_sharded"] == want_sharded
        assert {"dom_fwd", "fold0", "foldi0"} <= set(case["factored"])
        assert case["fallbacks"] == 0
        assert case["bytes"] == single["fri_drop"]


@pytest.mark.parametrize("world", [4, 2, 1])
def test_fetch_gives_every_rank_the_same_bytes(groups, world):
    """(g) `fetch` of each rank's block gathers the same array everywhere,
    in rank order."""
    import numpy as np
    ranks = _ranks(groups, world)
    want = np.concatenate([np.full((2, 5), r, dtype=np.int32) for r in range(world)],
                          axis=-1).tobytes()
    assert all(r["fetch"] == want for r in ranks)


@pytest.mark.parametrize("world", [4, 2, 1])
def test_make_mesh_raises_past_the_group(groups, world):
    """make_mesh raises where the group has fewer ranks than asked, as the
    JAX make_mesh does."""
    assert all(r["make_mesh_raises"] for r in _ranks(groups, world))


@pytest.mark.parametrize("world", [8, 4, 2, 1])
def test_every_collective_runs(groups, world):
    """Every collective of the mesh ran on every rank, a one-rank group
    included (no local shortcut): all_to_all_single in both its forms
    (equal blocks, and the FRI transpose's splits), all_gather and
    all_reduce."""
    ops = {"all_to_all_single", "all_to_all_single splits", "all_gather", "all_reduce"}
    for rank in _ranks(groups, world):
        assert {op for op, (calls, _, _) in rank["traffic"].items() if calls} == ops


def test_raising_rank_stops_the_group(groups):
    """(h) a rank that raises makes run_ranks raise, naming it, before
    the group's timeout, with the waiting rank killed."""
    _, exc, seconds = groups["raise"].result()
    assert isinstance(exc, RankError)
    assert "rank 1 gives up" in str(exc)
    assert seconds < RAISE_TIMEOUT_S


def test_hung_group_times_out(groups):
    """(h) a group still running at its timeout is killed and raises."""
    _, exc, seconds = groups["sleep"].result()
    assert isinstance(exc, RankError)
    assert "did not finish within 8.0 s" in str(exc)
    assert seconds < 30.0
