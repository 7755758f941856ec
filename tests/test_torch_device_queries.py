"""The port's device query sampling and batch-proof planning
(protocol/device_queries.py) against the JAX package: the plain sampler
against the JAX `sample_indexes_dev` on one case and against the host
`get_pseudorandom_indexes` on many seeds (odd hex lengths included, and
max_ = 2^32, where the JAX function's int32 wraps and only the host
function is the reference), every set of a proof at once, and both
augmentations and the fetch rows against the host functions and the JAX
device functions.  Seeds come from numpy or `random`; every comparison is
exact."""

import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genstark_tpu.merkle import _level_offset, plan_batch
from genstark_tpu.protocol import device_queries as jax_dq
from genstark_tpu.protocol.fri import get_augmented_positions as jax_fri_aug
from genstark_tpu.protocol.queries import get_pseudorandom_indexes
from genstark_tpu_torch.merkle import level_offset
from genstark_tpu_torch.protocol import device_queries as dq


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _words(seed: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(seed, dtype="<u4").view(np.int32).copy())


def _n_cand(count: int) -> int:
    return 32 * count + 512


def test_sampler_matches_jax_device():
    """The bench's execution set (48 of 2^17, multiples of 16 excluded)
    through both packages' vectorized samplers."""
    seed = bytes(np.random.default_rng(48).integers(0, 256, size=32, dtype=np.uint8))
    idx, found = dq.sample_indexes_ref(_words(seed), 48, 1 << 17, 16, _n_cand(48))
    jidx, jfound = jax_dq.sample_indexes_dev(
        jnp.asarray(np.frombuffer(seed, dtype="<u4")), 48, 1 << 17, 16, _n_cand(48))
    assert int(found) == int(jfound) == 48
    assert idx.tolist() == [int(v) for v in np.asarray(jidx)]


@pytest.mark.parametrize("count,max_,excl", [
    (48, 1 << 17, 16), (24, 1 << 15, 16), (32, 1 << 13, 4), (12, 1 << 10, 16),
    (8, 1 << 8, 0), (64, 1 << 25, 16), (24, 1 << 32, 16)])
def test_sampler_matches_host(count, max_, excl):
    """Four seeds a case; max_ = 2^32 puts indexes above 2^31."""
    rng = random.Random(count * 7919 + max_.bit_length() * 31 + excl)
    high = 0
    for _ in range(4):
        seed = bytes(rng.randrange(256) for _ in range(32))
        idx, found = dq.sample_indexes_ref(_words(seed), count, max_, excl, _n_cand(count))
        host = get_pseudorandom_indexes(seed, count, max_, excl)
        assert int(found) == count
        assert idx.dtype == torch.int64 and idx.tolist() == host
        high += sum(v >= 1 << 31 for v in host)
    if max_ == 1 << 32:
        assert high > 0


def test_sampler_odd_hex_lengths():
    """Seeds whose state sha256(seed) begins with a zero nibble: the hex
    string's length and the dropped odd nibble vary (as
    tests/test_device_queries.py:48 builds them)."""
    rng = random.Random(7)
    seeds = []
    while len(seeds) < 3:
        seed = bytes(rng.randrange(256) for _ in range(32))
        if hashlib.sha256(seed).digest()[0] < 16:
            seeds.append(seed)
    for seed in seeds:
        idx, found = dq.sample_indexes_ref(_words(seed), 16, 1 << 12, 4, 1024)
        assert int(found) == 16
        assert idx.tolist() == get_pseudorandom_indexes(seed, 16, 1 << 12, 4)


def test_sample_sets_and_exhaustion():
    """Every set of a proof at once (the bench's: 48 execution positions,
    24 per FRI layer), zero-padded to the largest count; a window too small
    reports found < count, with the positions it did find first."""
    rng = random.Random(5)
    seeds = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(4)]
    specs = [(48, 1 << 17, 16, _n_cand(48))] + [
        (24, 1 << k, 16, _n_cand(24)) for k in (15, 13, 11)]
    roots = torch.stack([_words(s) for s in seeds])
    idx, found = dq.sample_sets(roots, specs)
    assert idx.shape == (4, 48) and found.tolist() == [48, 24, 24, 24]
    for s, (count, max_, excl, _) in enumerate(specs):
        assert idx[s, :count].tolist() == get_pseudorandom_indexes(seeds[s], count, max_, excl)
        assert not idx[s, count:].any()
    idx, found = dq.sample_sets(roots[:1], [(48, 1 << 17, 16, 8)])
    host = get_pseudorandom_indexes(seeds[0], 48, 1 << 17, 16)
    n = int(found[0])
    assert n < 48 and idx[0, :n].tolist() == host[:n]


def test_augmentations_match_host_and_jax():
    """Ten cases against the host functions, the first three also against
    the JAX device functions (each shape is one XLA compile)."""
    rng = random.Random(3)
    for case in range(10):
        N = 1 << rng.randrange(8, 16)
        ext = 16
        C = rng.randrange(4, 40)
        pos = rng.sample(range(N), C)
        want = list(dict.fromkeys(v for p in pos for v in (p, (p + ext) % N)))
        aug, n = dq.augment_stark(torch.as_tensor(pos, dtype=torch.int64), ext, N)
        assert int(n) == len(want) and aug.tolist()[:len(want)] == want
        # the FRI form, two sets at once: the second one's padding is dead
        want_f = jax_fri_aug(pos, N)
        if case < 3:
            jaug, jn = jax_dq.augment_stark(jnp.asarray(pos, dtype=jnp.int32), ext, N)
            assert int(jn) == len(want)
            assert [int(v) for v in np.asarray(jaug)][:len(want)] == want
            jf, jnf = jax_dq.augment_fri(jnp.asarray(pos, dtype=jnp.int32), N)
            assert int(jnf) == len(want_f)
            assert [int(v) for v in np.asarray(jf)][:len(want_f)] == want_f
        positions = torch.as_tensor([pos, pos[:C // 2] + [0] * (C - C // 2)], dtype=torch.int64)
        live = torch.arange(C)[None] < torch.as_tensor([C, C // 2])[:, None]
        augf, nf = dq.augment_fri(positions, live, torch.as_tensor([N // 4 - 1, N // 4 - 1]))
        assert int(nf[0]) == len(want_f) and augf[0].tolist()[:len(want_f)] == want_f
        want_h = jax_fri_aug(pos[:C // 2], N)
        assert int(nf[1]) == len(want_h) and augf[1].tolist()[:len(want_h)] == want_h


def test_plan_rows_match_host_and_jax():
    """One plan at a time against plan_batch and the JAX plan_rows_dev,
    padded slots ignored; each package's rows in its own tree layout (the
    port's flat tree has exact levels, the JAX one fixed windows); the JAX
    function on the first three of ten cases (each shape is one compile)."""
    rng = random.Random(11)
    for case in range(10):
        depth = rng.randrange(3, 14)
        n = 1 << depth
        C = rng.randrange(2, min(40, n))
        pos = rng.sample(range(n), C)
        _, coords = plan_batch(pos, depth)
        want = [level_offset(n, level) + idx for level, idx in coords]
        want_jax = [_level_offset(n, level) + idx for level, idx in coords]
        pos_pad = pos + [0] * 3
        rows, n_rows = dq.plan_rows_dev(torch.as_tensor(pos_pad), C, depth, n, level_offset)
        assert int(n_rows) == len(want) and rows.tolist()[:len(want)] == want
        if case < 3:
            jrows, jn = jax_dq.plan_rows_dev(jnp.asarray(pos_pad, dtype=jnp.int32), C, depth, n,
                                             (C + 3) * (1 + depth), _level_offset)
            assert int(jn) == len(want)
            assert [int(v) for v in np.asarray(jrows)][:len(want)] == want_jax


def test_plan_rows_batch_many_plans():
    """Plans of several depths and bases in one call, compacted in order,
    equal to the host's concatenated fetch lists."""
    rng = random.Random(13)
    depths = [9, 5, 12, 3]
    bases = [0, 1000, 2000, 9000]
    C = 20
    plans, want = [], []
    for depth, base in zip(depths, bases):
        n = 1 << depth
        k = rng.randrange(2, min(C, n) + 1)
        pos = rng.sample(range(n), k)
        plans.append(pos)
        _, coords = plan_batch(pos, depth)
        want += [base + level_offset(n, level) + idx for level, idx in coords]
    D = max(depths)
    positions = torch.as_tensor([p + [0] * (C - len(p)) for p in plans])
    live = torch.arange(C)[None] < torch.as_tensor([len(p) for p in plans])[:, None]
    offsets = torch.as_tensor([[level_offset(1 << d, lv) if lv < d else 0 for lv in range(D)]
                               for d in depths])
    rows, keep = dq.plan_rows_batch(positions, live, torch.as_tensor(depths), offsets,
                                    torch.as_tensor(bases))
    cap = len(want) + 5
    out, n = dq.compact(rows, keep, cap)
    assert int(n) == len(want)
    assert out.tolist() == want + [0] * 5
