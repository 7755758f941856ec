"""Hash layer: sha256 / blake2s256, host (hashlib) and batched on the device.

Counterpart of ``genstark_tpu/hash/__init__.py`` (`Hash.digest`,
`digest_rows`, `merge_element_rows`, `digest_stride_rows`, `hash_pairs`).
Device messages and digests are WORD-MAJOR int32 tensors of LE-byte words:
messages [W, B], digests [8, B] (the JAX package's layout, its uint32 bits
held in int32).

Kernels: `digest_rows` on a CUDA tensor launches kernel 2
(csrc/hash.cu gs_hash_words); `merge_element_rows` and `digest_stride_rows`
launch kernel 3 (gs_hash_limbs), which builds each message word lo | hi<<16
from the limb arrays in the kernel.  CPU tensors run the plain versions in
hash/blake2s.py and hash/sha256.py.
"""

from __future__ import annotations

import hashlib
from typing import List

import numpy as np
import torch

from .. import kernels
from . import blake2s as _blake2s
from . import sha256 as _sha256

HASH_ALGORITHMS = ("sha256", "blake2s256")


def digests_to_bytes(digests: np.ndarray) -> List[bytes]:
    """uint32[8, B] word-major LE-word digests -> list of 32-byte digests."""
    arr = np.ascontiguousarray(np.asarray(digests).astype("<u4").T)
    raw = arr.tobytes()
    return [raw[i * 32:(i + 1) * 32] for i in range(arr.shape[0])]


def elements_to_words(limbs: torch.Tensor) -> torch.Tensor:
    """Standard-form 16-bit limbs [L, N] -> LE words [L/2, N] as int64
    (lo | hi << 16 needs 32 unsigned bits)."""
    wide = limbs.to(torch.int64)
    return wide[0::2] | (wide[1::2] << 16)


def digest_rows_ref(algorithm: str, words: torch.Tensor, msg_bytes: int) -> torch.Tensor:
    """Plain version of kernel 2: [W, B] LE words (any int dtype holding
    32-bit values) -> int32 [8, B] digests."""
    mod = _sha256 if algorithm == "sha256" else _blake2s
    return mod.digest_rows_le(words.to(torch.int64) & 0xFFFFFFFF, msg_bytes).to(torch.int32)


class Hash:
    def __init__(self, algorithm: str):
        if algorithm not in HASH_ALGORITHMS:
            raise ValueError(f"Hash algorithm {algorithm} is not supported")
        self.algorithm = algorithm
        self.digest_size = 32

    # ----- host path --------------------------------------------------------
    def digest(self, data: bytes) -> bytes:
        if self.algorithm == "sha256":
            return hashlib.sha256(data).digest()
        return hashlib.blake2s(data).digest()

    # ----- device batch paths ----------------------------------------------
    def digest_rows(self, words: torch.Tensor, msg_bytes: int) -> torch.Tensor:
        """Hash B equal-size messages: [W, B] LE words -> int32 [8, B]."""
        if words.device.type == "cpu":
            return digest_rows_ref(self.algorithm, words, msg_bytes)
        return kernels.hash_words(self.algorithm, words.to(torch.int32).contiguous(),
                                  msg_bytes)

    def merge_element_rows(self, vectors_std, element_size: int) -> torch.Tensor:
        """Leaf hashing across vectors: leaf_i = H(v0[i] || v1[i] || ...).
        vectors_std: standard-form limbs [V, L, N], or a list of V [L, N]
        vectors as the JAX one takes (hash/__init__.py:101); returns [8, N]."""
        if isinstance(vectors_std, (list, tuple)):
            vectors_std = torch.stack(vectors_std)
        V, L, N = vectors_std.shape
        if 2 * L != element_size:
            raise ValueError("element size does not match the limb count")
        if vectors_std.device.type == "cpu":
            words = torch.cat([elements_to_words(vectors_std[v]) for v in range(V)])
            return digest_rows_ref(self.algorithm, words, element_size * V)
        return kernels.hash_limbs(self.algorithm, vectors_std.contiguous(), rows=False)

    def digest_stride_rows(self, values_std: torch.Tensor, element_size: int) -> torch.Tensor:
        """FRI row hashing: values [L, N] -> row r = v[r] || v[r+M] ||
        v[r+2M] || v[r+3M] with M = N/4, hashed -> [8, M]."""
        L, N = values_std.shape
        M = N // 4
        if values_std.device.type == "cpu":
            words = torch.cat([elements_to_words(values_std[:, k * M:(k + 1) * M])
                               for k in range(4)])
            return digest_rows_ref(self.algorithm, words, element_size * 4)
        return kernels.hash_limbs(self.algorithm, values_std.contiguous(), rows=True)

    def hash_pairs(self, digests: torch.Tensor) -> torch.Tensor:
        """One Merkle level: [8, 2N] -> [8, N]; pair k = leaves 2k, 2k+1."""
        pairs = torch.cat([digests[:, 0::2], digests[:, 1::2]], dim=0)   # [16, N]
        return self.digest_rows(pairs.contiguous(), 64)


def create_hash(algorithm: str) -> Hash:
    return Hash(algorithm)
