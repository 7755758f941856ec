"""The Fiat-Shamir transcript on the device: the sha256-counter PRNG.

Counterpart of ``genstark_tpu/protocol/fiat_shamir.py``.  The prover draws
its composition and linear-combination coefficients from the evaluation
root and each FRI layer's specialX from the layer's root; these functions
derive them on the device, equal to `HostField.prng` (field/host.py):

    state = sha256(seed)
    v_i   = int_be(sha256(state || u64_be(i))) mod p

so no root is fetched mid-proof.  Seeds and digests are int32 tensors of
LE-byte words (the hash layer's layout); the hashes are kernel 2 on the
card (`Hash.digest_rows`, 32- and 40-byte messages) and the reduction mod
p is ceil(16/L) kernel-5 products plus adds.  A CPU tensor runs the plain
versions.
"""

from __future__ import annotations

import torch

from ..hash import create_hash
from ..hash.sha256 import byteswap32

_SHA256 = create_hash("sha256")


def digest_words_to_field_mont(dev, digests: torch.Tensor) -> torch.Tensor:
    """256-bit big-endian digests mod p, in Montgomery form.

    digests: int32 [8, N] LE-byte words.  Returns int32 [L, N] Montgomery
    elements of int_be(digest bytes) % p: the value's 16 limbs, folded in
    chunks of L with one product each against D_j = 2^(16 L j) R^2 mod p
    (a chunk below 2^(16L) is a legal operand: the product's REDC output
    stays below 2p before its final subtraction)."""
    L, n = dev.L, digests.shape[1]
    v32 = byteswap32(digests.flip(0).to(torch.int64) & 0xFFFFFFFF)      # [8, N] LE 32-bit limbs
    u16 = torch.stack([v32 & 0xFFFF, v32 >> 16], dim=1).reshape(16, n)
    n_chunks = -(-16 // L)
    u16 = torch.nn.functional.pad(u16, (0, 0, 0, n_chunks * L - 16)).to(torch.int32)
    acc = None
    for j in range(n_chunks):
        d_j = pow(2, 16 * L * j, dev.p) * dev.params.R2_mod % dev.p
        term = dev.mont_mul(u16[j * L:(j + 1) * L], dev.const(d_j, (1,), to_mont=False))
        acc = term if acc is None else dev._add(acc, term)
    return acc


def prng_elements_dev(dev, seed_words: torch.Tensor, count: int) -> torch.Tensor:
    """field.prng(seed, count) on the device.  seed_words: int32 [8], a
    32-byte seed's LE words.  Returns int32 [L, count] Montgomery."""
    state = _SHA256.digest_rows(seed_words.reshape(8, 1), 32)            # [8, 1]
    idx = torch.arange(count, dtype=torch.int64, device=seed_words.device)
    # u64_be(i) as LE-byte words: 0, then byteswap32(i) (i < 2^32)
    msgs = torch.cat([state.to(torch.int64).expand(8, count),
                      torch.zeros((1, count), dtype=torch.int64, device=idx.device),
                      byteswap32(idx)[None]]).to(torch.int32)                 # [10, count]
    return digest_words_to_field_mont(dev, _SHA256.digest_rows(msgs, 40))


def prng_single_dev(dev, seed_words: torch.Tensor) -> torch.Tensor:
    """field.prng(seed) on the device: [L, 1] Montgomery."""
    return prng_elements_dev(dev, seed_words, 1)


def root_words(flat_tree: torch.Tensor) -> torch.Tensor:
    """The root digest [8] of a flat tree (merkle.build_tree_flat: root
    last), as int32 LE words."""
    return flat_tree[:, -1]
