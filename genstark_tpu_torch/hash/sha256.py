"""SHA-256 over word-major batches of LE words: the plain torch version of
the hash kernels (csrc/hash.cu).

Counterpart of ``genstark_tpu/hash/sha256.py``.  Messages are LE-byte
words (SHA-256 reads the byte stream big-endian, so words are byte-swapped
in and the state is byte-swapped out).  Words are int64 tensors holding
32-bit values; every sum is masked back to 32 bits.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF

K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2)

H0 = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)


def rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & M32


def bswap(x: torch.Tensor) -> torch.Tensor:
    return (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00) |
            ((x << 8) & 0xFF0000) | ((x << 24) & 0xFF000000))


def digest_rows_le(words: torch.Tensor, msg_bytes: int) -> torch.Tensor:
    """SHA-256 of B equal-length messages: int64 [ceil(msg/4), B] LE words
    (partial last word zero-padded) -> int64 [8, B] LE digest words."""
    n_words, B = words.shape
    if n_words != (msg_bytes + 3) // 4:
        raise ValueError("word count does not match the message length")
    n_blocks = (msg_bytes + 9 + 63) // 64
    total = n_blocks * 16
    zero = torch.zeros((B,), dtype=torch.int64, device=words.device)
    rows = [words[i] for i in range(n_words)] + [zero] * (total - n_words)
    term_word, term_shift = msg_bytes // 4, (msg_bytes % 4) * 8
    rows[term_word] = rows[term_word] | (0x80 << term_shift)
    be = [bswap(w) for w in rows]
    bitlen = msg_bytes * 8
    be[total - 2] = torch.full_like(zero, bitlen >> 32)
    be[total - 1] = torch.full_like(zero, bitlen & M32)
    state = [torch.full_like(zero, x) for x in H0]
    for blk in range(n_blocks):
        w = be[blk * 16:(blk + 1) * 16]
        a, b, c, d, e, f, g, h = state
        for r in range(64):
            if r >= 16:
                w1, w9, w14 = w[(r + 1) % 16], w[(r + 9) % 16], w[(r + 14) % 16]
                s0 = rotr(w1, 7) ^ rotr(w1, 18) ^ (w1 >> 3)
                s1 = rotr(w14, 17) ^ rotr(w14, 19) ^ (w14 >> 10)
                w[r % 16] = (w[r % 16] + s0 + w9 + s1) & M32
            S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
            ch = (e & f) ^ (~e & g & M32)
            t1 = (h + S1 + ch + K[r] + w[r % 16]) & M32
            S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            a, b, c, d, e, f, g, h = (t1 + S0 + maj) & M32, a, b, c, (d + t1) & M32, e, f, g
        state = [(x + y) & M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]
    return torch.stack([bswap(x) for x in state])
