"""Proof object model: StarkProof / LowDegreeProof / FriComponent.

Counterpart of ``genstark_tpu/protocol/proof.py`` (a copy)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..merkle import BatchMerkleProof


@dataclass
class FriComponent:
    column_root: bytes
    column_proof: BatchMerkleProof
    poly_proof: BatchMerkleProof


@dataclass
class LowDegreeProof:
    lc_root: bytes
    lc_proof: BatchMerkleProof
    components: List[FriComponent]
    remainder: List[int]


@dataclass
class StarkProof:
    ev_root: bytes
    ev_proof: BatchMerkleProof
    ld_proof: LowDegreeProof
    i_shapes: List[List[int]]
