"""BLAKE2s-256 over word-major batches of LE words: the plain torch version
of the hash kernels (csrc/hash.cu).

Counterpart of ``genstark_tpu/hash/blake2s.py`` (RFC 7693, digest length
32, no key — identical to hashlib.blake2s).  Words are int64 tensors
holding 32-bit values; every sum is masked back to 32 bits.
"""

from __future__ import annotations

import hashlib
from typing import List

import torch

M32 = 0xFFFFFFFF

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)

_G_WIRING = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
             (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & M32


def _compress(h: List[torch.Tensor], m: List[torch.Tensor], t: int,
              last: bool) -> List[torch.Tensor]:
    v = list(h) + [torch.full_like(h[0], x) for x in IV]
    v[12] = v[12] ^ (t & M32)
    v[13] = v[13] ^ ((t >> 32) & M32)
    if last:
        v[14] = v[14] ^ M32
    for s in SIGMA:
        for gi, (a, b, c, d) in enumerate(_G_WIRING):
            x, y = m[s[2 * gi]], m[s[2 * gi + 1]]
            va = (v[a] + v[b] + x) & M32
            vd = rotr(v[d] ^ va, 16)
            vc = (v[c] + vd) & M32
            vb = rotr(v[b] ^ vc, 12)
            va = (va + vb + y) & M32
            vd = rotr(vd ^ va, 8)
            vc = (vc + vd) & M32
            vb = rotr(vb ^ vc, 7)
            v[a], v[b], v[c], v[d] = va, vb, vc, vd
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def digest_rows_le(words_le: torch.Tensor, msg_bytes: int) -> torch.Tensor:
    """BLAKE2s-256 of B equal-length messages: int64 [ceil(msg/4), B] LE
    words -> int64 [8, B] LE digest words."""
    n_words, B = words_le.shape
    if n_words != (msg_bytes + 3) // 4:
        raise ValueError("word count does not match the message length")
    n_blocks = max(1, (msg_bytes + 63) // 64)
    zero = torch.zeros((B,), dtype=torch.int64, device=words_le.device)
    rows = [words_le[i] for i in range(n_words)] + [zero] * (n_blocks * 16 - n_words)
    h = [torch.full_like(zero, x) for x in IV]
    h[0] = h[0] ^ 0x01010020             # digest_length=32, fanout=1, depth=1
    for blk in range(n_blocks):
        last = blk == n_blocks - 1
        t = msg_bytes if last else (blk + 1) * 64
        h = _compress(h, rows[blk * 16:(blk + 1) * 16], t, last)
    return torch.stack(h)


def digest_host(data: bytes) -> bytes:
    return hashlib.blake2s(data).digest()
