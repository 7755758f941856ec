"""Fiat-Shamir query index sampling on the host.

Counterpart of ``genstark_tpu/protocol/queries.py`` (a copy): bit-exact
replication of the reference's QueryIndexGenerator, including the Node.js
Buffer.from(hex) quirk — `sha256(state + i)` hex-encodes the bigint and
Node silently drops a trailing odd nibble, so this does the same.
"""

from __future__ import annotations

import hashlib
from typing import List


def _sha256_int(value) -> int:
    """sha256 over a bigint's hex-encoding (Node Buffer.from(x.toString(16),
    'hex') semantics: trailing odd nibble dropped) or over raw bytes."""
    if isinstance(value, int):
        hex_str = format(value, "x")
        if len(hex_str) % 2:
            hex_str = hex_str[:-1]          # Node drops the incomplete pair
        data = bytes.fromhex(hex_str)
    else:
        data = value
    return int.from_bytes(hashlib.sha256(data).digest(), "big")


def get_pseudorandom_indexes(seed: bytes, count: int, max_: int,
                             exclude_multiples_of: int = 0) -> List[int]:
    max_count = max_ - max_ // exclude_multiples_of if exclude_multiples_of else max_
    if max_count < count:
        raise ValueError(
            f"Cannot select {count} unique pseudorandom indexes from {max_} values")
    max_iterations = count * 1000
    indexes = dict()                         # insertion-ordered set
    state = _sha256_int(seed)
    for i in range(max_iterations):
        index = _sha256_int(state + i) % max_
        if exclude_multiples_of and index % exclude_multiples_of == 0:
            continue
        if index in indexes:
            continue
        indexes[index] = True
        if len(indexes) >= count:
            break
    if len(indexes) < count:
        raise ValueError(f"Could not generate {count} pseudorandom indexes")
    return list(indexes.keys())


class QueryIndexGenerator:
    def __init__(self, extension_factor: int, exe_query_count: int,
                 fri_query_count: int):
        self.extension_factor = extension_factor
        self.exe_query_count = exe_query_count
        self.fri_query_count = fri_query_count

    def get_exe_indexes(self, seed: bytes, domain_size: int) -> List[int]:
        query_count = min(self.exe_query_count,
                          domain_size - domain_size // self.extension_factor)
        return get_pseudorandom_indexes(seed, query_count, domain_size,
                                        self.extension_factor)

    def get_fri_indexes(self, seed: bytes, column_length: int) -> List[int]:
        return get_pseudorandom_indexes(seed, self.fri_query_count, column_length,
                                        self.extension_factor)

    def get_augmented_positions(self, positions: List[int], domain_size: int) -> List[int]:
        """Evaluation spot checks: pos and (pos + ext) mod N, insertion-ordered
        dedup (the JAX package's `Stark._get_augmented_positions`)."""
        skip = self.extension_factor
        out = dict()
        for p in positions:
            out[p] = True
            out[(p + skip) % domain_size] = True
        return list(out.keys())
