"""The port's hash layer (plain versions of kernels 2 and 3) and Merkle
trees against the JAX package and hashlib, exactly."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genstark_tpu.hash import create_hash as jax_hash
from genstark_tpu_torch.field import P128
from genstark_tpu_torch.hash import create_hash, digests_to_bytes
from genstark_tpu_torch.merkle import MerkleTree, build_tree_flat, level_offset

ALGOS = pytest.mark.parametrize("algo", ["sha256", "blake2s256"])


def _limbs(rng, shape):
    out = rng.integers(0, 1 << 16, size=shape, dtype=np.int64)
    out[..., 7, :] = rng.integers(0, P128 >> 112, size=out[..., 7, :].shape)
    return out.astype(np.uint32)


def _same(port_out, jax_out):
    assert np.array_equal(port_out.numpy().astype(np.uint32), np.asarray(jax_out))


@ALGOS
def test_merge_element_rows_matches_jax(algo):
    vecs = _limbs(np.random.default_rng(1), (2, 8, 256))
    got = create_hash(algo).merge_element_rows(torch.from_numpy(vecs.astype(np.int32)), 16)
    want = jax_hash(algo).merge_element_rows([jnp.asarray(v) for v in vecs], 16)
    _same(got, want)


@ALGOS
def test_digest_stride_rows_matches_jax(algo):
    vals = _limbs(np.random.default_rng(2), (8, 1024))
    got = create_hash(algo).digest_stride_rows(torch.from_numpy(vals.astype(np.int32)), 16)
    want = jax_hash(algo).digest_stride_rows(jnp.asarray(vals), 16)
    _same(got, want)


@ALGOS
def test_hash_pairs_matches_jax(algo):
    words = np.random.default_rng(3).integers(0, 1 << 32, size=(8, 512), dtype=np.uint64)
    words = words.astype(np.uint32)
    got = create_hash(algo).hash_pairs(torch.from_numpy(words.view(np.int32)))
    want = jax_hash(algo).hash_pairs(jnp.asarray(words))
    _same(got, want)


@ALGOS
@pytest.mark.parametrize("msg_bytes", [4, 32, 52, 64, 100, 128])
def test_digest_rows_matches_hashlib(algo, msg_bytes):
    rng = np.random.default_rng(msg_bytes)
    msgs = [rng.bytes(msg_bytes) for _ in range(5)]
    words = np.stack([np.frombuffer(m, dtype="<u4") for m in msgs], axis=1)
    got = create_hash(algo).digest_rows(torch.from_numpy(words.view(np.int32).copy()),
                                        msg_bytes)
    ref = hashlib.sha256 if algo == "sha256" else hashlib.blake2s
    assert digests_to_bytes(got.numpy()) == [ref(m).digest() for m in msgs]


def test_merkle_root_pinned():
    """The pinned root of the JAX package's compatibility vectors, from the
    host tree and from the device flat tree."""
    h = create_hash("sha256")
    leaves = [hashlib.sha256(bytes([i])).digest() for i in range(8)]
    want = "0727b310f87099c1ba2ec0ba408def82c308237c8577f0bdfd2643e9cc6b7578"
    tree = MerkleTree.create_from_bytes(leaves, h)
    assert tree.root.hex() == want
    proof = tree.prove_batch([1, 6])
    assert [[d.hex()[:8] for d in col] for col in proof.nodes] == [
        ["6e340b9c", "c2768b34"], ["ca358758", "f03808f5"]]
    words = np.stack([np.frombuffer(x, dtype="<u4") for x in leaves], axis=1)
    flat = build_tree_flat(h, torch.from_numpy(words.view(np.int32).copy()), 8)
    assert flat.shape == (8, 15)
    assert digests_to_bytes(flat[:, -1:].numpy())[0].hex() == want
    # level offsets: leaves first, root last
    assert [level_offset(8, k) for k in range(4)] == [0, 8, 12, 14]
