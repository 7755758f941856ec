"""Merkle commitment layer.

Counterpart of ``genstark_tpu/merkle/__init__.py``.  `build_tree_flat`
builds every level on the device with `Hash.hash_pairs` (kernel 2 on CUDA)
into one word-major [8, 2n - 1] buffer in the port's own layout: exact
levels, leaves first, root last (level k starts at row `level_offset(n,
k)`); `build_tree_sharded` builds a rank's part of a tree whose leaves are
sharded over a mesh (its subtree, then the replicated top), and
`sharded_tree_rows` maps a row of the whole tree into that layout.  Proof scheduling (`plan_batch`) and assembly (`assemble_batch`) are
host index bookkeeping, copied from the JAX package so the proofs carry the
same sibling schedule.  `MerkleTree` (JAX :187-305) is the device tree of
the staged prover (`create`, `_fetch_nodes`, `prove_batch`: the root and
each batch proof's digests are one fetch each) or a host tree over bytes
(`create_from_bytes`, for small trees and the pinned-root check), and
`MerkleTree.verify_batch` replays the schedule for the verifier.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from .. import tracing
from ..hash import Hash, digests_to_bytes  # noqa: F401  (re-exported, as in the JAX package)


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


def build_tree_sharded(h, leaves: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """A rank's part of the flat tree over n leaves sharded over a mesh of
    D ranks (the JAX package's per-shard Merkle hashing): leaves [8, n/D]
    is the rank's block; its subtree (`build_tree_flat`, 2n/D - 1 rows),
    one list-form `all_gather` of the D subtree roots, then the tree over
    them (2D - 1 rows), the same on every rank.  Returns
    [8, sharded_row_count(n, D)], the root last, as `build_tree_flat`'s."""
    sub = build_tree_flat(h, leaves, n // mesh.size)
    tops = torch.stack(mesh.all_gather(sub[:, -1]), dim=1)          # [8, D]
    return torch.cat([sub, build_tree_flat(h, tops, mesh.size)], dim=1)


def sharded_row_count(n: int, D: int) -> int:
    """Rows of a rank's part of a sharded tree (`build_tree_sharded`)."""
    return tree_row_count(n // D) + tree_row_count(D)


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bit lengths of int64 values below 2^53 (0 for 0), exactly."""
    return torch.frexp(x.to(torch.float64))[1].to(torch.int64)


def sharded_tree_rows(g: torch.Tensor, n, D: int):
    """Where the rows g (int64, `level_offset(n, level) + idx` of the flat
    tree over n leaves; n an int or an int64 tensor broadcast with g) lie
    in `build_tree_sharded`'s layout over D ranks: (owner rank, row in the
    owner's part).  A row of a level wider than D belongs to the rank whose
    block holds it; the levels of the top tree are on every rank and are
    given to rank 0, so every row has exactly one owner."""
    n = torch.as_tensor(n, dtype=torch.int64, device=g.device)
    d = _bit_length(n) - 1
    level = d + 1 - _bit_length(2 * n - g - 1)
    width = torch.bitwise_right_shift(n, level)
    idx = g - (2 * n - 2 * width)
    sub = width > D
    bw = torch.clamp(width // D, min=1)
    nb = n // D
    owner = torch.where(sub, idx // bw, torch.zeros_like(idx))
    local = torch.where(sub, 2 * nb - 2 * bw + idx % bw, 2 * nb - 1 + 2 * D - 2 * width + idx)
    return owner, local


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
    """A tree on the device (`create`: its flat buffer stays there, only the
    root comes to the host) or on the host (`create_from_bytes`, for small
    trees such as the FRI remainder's re-commit)."""

    def __init__(self, hash_, depth: int, levels: Optional[List[List[bytes]]] = None,
                 flat_dev: Optional[torch.Tensor] = None, root: Optional[bytes] = None):
        self.hash = hash_
        self.depth = depth
        self._levels = levels            # host mode: levels[0] = leaves ... [root]
        self._flat = flat_dev            # device mode: build_tree_flat's buffer
        self._root = root

    @property
    def root(self) -> bytes:
        if self._root is None:
            self._root = self._levels[-1][0]
        return self._root

    @property
    def leaf_count(self) -> int:
        return 1 << self.depth

    @classmethod
    def create(cls, leaves: torch.Tensor, hash_) -> "MerkleTree":
        """leaves: int32 [8, N] word-major digests on the device (N a power
        of 2), hashed level by level with `build_tree_flat` (kernel 2 on a
        CUDA tensor).  The tree stays on the device; the root, its last row,
        is the one fetch (JAX `MerkleTree.create`, merkle/__init__.py:211)."""
        n = int(leaves.shape[1])
        if n < 1 or n & (n - 1):
            raise ValueError("leaf count must be a power of 2")
        flat = build_tree_flat(hash_, leaves, n)
        root = tracing.fetch(flat[:, -1]).numpy().astype("<u4").tobytes()
        return cls(hash_, n.bit_length() - 1, flat_dev=flat, root=root)

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
        return cls(hash_, n.bit_length() - 1, levels=levels)

    def _fetch_nodes(self, coords: Sequence[tuple]) -> List[bytes]:
        """Digests at [(level, idx), ...]: on the device one `index_select`
        over the flat buffer and one fetch."""
        if not coords:
            return []
        if self._flat is None:
            return [self._levels[level][idx] for level, idx in coords]
        n = self.leaf_count
        offsets = tracing.upload([level_offset(n, level) + idx for level, idx in coords],
                                 torch.int64, self._flat.device)
        rows = tracing.fetch(self._flat.index_select(1, offsets).T.contiguous()).numpy()
        raw = rows.astype("<u4").tobytes()
        return [raw[32 * i:32 * (i + 1)] for i in range(len(coords))]

    def prove_batch(self, positions: Sequence[int]) -> BatchMerkleProof:
        """Batched authentication paths (plan_batch's schedule), every
        digest fetched at once."""
        emissions, coords = plan_batch(positions, self.depth)
        return assemble_batch(positions, self.depth, emissions, self._fetch_nodes(coords))

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
