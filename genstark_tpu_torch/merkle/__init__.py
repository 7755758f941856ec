"""Merkle commitment layer.

Counterpart of ``genstark_tpu/merkle/__init__.py``.  `build_tree_flat`
builds every level on the device with `Hash.hash_pairs` (kernel 2 on CUDA)
into one word-major [8, 2n - 1] buffer in the port's own layout: exact
levels, leaves first, root last (level k starts at row `level_offset(n,
k)`).  Proof scheduling (`plan_batch`) and assembly (`assemble_batch`) are
host index bookkeeping, copied from the JAX package so the proofs carry the
same sibling schedule; `MerkleTree` is the host-side tree used for small
trees and the pinned-root check, and `MerkleTree.verify_batch` (JAX :264)
replays the schedule for the verifier.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch


def level_offset(n: int, level: int) -> int:
    """Row offset of `level` (0 = leaves) in a flat tree over n leaves."""
    return 2 * n - 2 * (n >> level)


def tree_row_count(n: int) -> int:
    return 2 * n - 1


def build_tree_flat(h, leaves: torch.Tensor, n: int) -> torch.Tensor:
    """leaves [8, n] word-major digests -> [8, 2n - 1] flat tree."""
    levels = [leaves]
    cur = leaves
    while cur.shape[1] > 1:
        cur = h.hash_pairs(cur)
        levels.append(cur)
    return torch.cat(levels, dim=1)


@dataclass
class BatchMerkleProof:
    """values[i] belongs to positions[i] (caller order); nodes[i] is the
    column of sibling digests consumed by position i's authentication walk."""
    values: List[bytes]
    nodes: List[List[bytes]]
    depth: int


def plan_batch(positions: Sequence[int], depth: int):
    """Proof schedule for a batch of positions: (emissions, coords) with
    emissions (column, level, sibling) in emission order and coords the
    fetch list [(0, p) per position] + [(level, sibling) ...]."""
    if len(set(positions)) != len(positions):
        raise ValueError("positions must be unique")
    emissions: List[tuple] = []
    available = set(positions)
    for level in range(depth):
        done = set()
        parents = set()
        for ci, p in enumerate(positions):
            idx = p >> level
            if idx in done or (idx ^ 1) in done:
                continue
            done.add(idx)
            sib = idx ^ 1
            if sib not in available:
                emissions.append((ci, level, sib))
            parents.add(idx >> 1)
        available = parents
    coords = [(0, p) for p in positions] + [(lvl, sib) for _, lvl, sib in emissions]
    return emissions, coords


def assemble_batch(positions: Sequence[int], depth: int, emissions,
                   fetched: List[bytes]) -> BatchMerkleProof:
    """The proof object from plan_batch's schedule and the fetched digests
    (in coords order)."""
    values = fetched[:len(positions)]
    columns: List[List[bytes]] = [[] for _ in positions]
    for (ci, _, _), val in zip(emissions, fetched[len(positions):]):
        columns[ci].append(val)
    return BatchMerkleProof(values=values, nodes=columns, depth=depth)


class MerkleTree:
    """Host-side tree over 32-byte leaves."""

    def __init__(self, hash_, levels: List[List[bytes]]):
        self.hash = hash_
        self.depth = len(levels) - 1
        self._levels = levels

    @property
    def root(self) -> bytes:
        return self._levels[-1][0]

    @classmethod
    def create_from_bytes(cls, leaves: Sequence[bytes], hash_) -> "MerkleTree":
        n = len(leaves)
        if n < 1 or n & (n - 1):
            raise ValueError("leaf count must be a power of 2")
        levels = [list(leaves)]
        cur = list(leaves)
        while len(cur) > 1:
            cur = [hash_.digest(cur[2 * i] + cur[2 * i + 1]) for i in range(len(cur) // 2)]
            levels.append(cur)
        return cls(hash_, levels)

    def prove_batch(self, positions: Sequence[int]) -> BatchMerkleProof:
        emissions, coords = plan_batch(positions, self.depth)
        fetched = [self._levels[level][idx] for level, idx in coords]
        return assemble_batch(positions, self.depth, emissions, fetched)

    @staticmethod
    def verify_batch(root: bytes, positions: Sequence[int],
                     proof: BatchMerkleProof, hash_) -> bool:
        """Verify a batched proof.  proof.values must already be leaf digests
        (the protocol rehashes raw leaf bytes first)."""
        if len(positions) != len(proof.values):
            return False
        if len(set(positions)) != len(positions):
            return False
        if len(proof.nodes) != len(positions):
            return False
        depth = proof.depth
        level_vals = {}
        for p, v in zip(positions, proof.values):
            if not (0 <= p < (1 << depth)):
                return False
            level_vals[p] = v
        cursors = [0] * len(positions)
        for level in range(depth):
            done = set()
            parents = {}
            for ci, p in enumerate(positions):
                idx = p >> level
                if idx in done or (idx ^ 1) in done:
                    continue
                done.add(idx)
                sib = idx ^ 1
                if sib not in level_vals:
                    col = proof.nodes[ci]
                    if cursors[ci] >= len(col):
                        return False
                    level_vals[sib] = col[cursors[ci]]
                    cursors[ci] += 1
                a = level_vals.get(idx)
                if a is None:
                    return False
                b = level_vals[sib]
                left, right = (a, b) if idx % 2 == 0 else (b, a)
                parents[idx >> 1] = hash_.digest(left + right)
            level_vals = parents
        for ci, col in enumerate(proof.nodes):
            if cursors[ci] != len(col):
                return False                      # trailing unconsumed nodes
        return level_vals.get(0) == root
