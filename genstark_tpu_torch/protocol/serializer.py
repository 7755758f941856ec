"""Byte-exact proof writer.

Counterpart of the write side of ``genstark_tpu/protocol/serializer.py``
(copied; the JAX package's `parse_proof` reads what this writes):
- merkle-proof sublayout: array length u8 with 0 == 256; matrix of node
  columns with u8 `(len << 1) | type` headers, type = leaf(1)/node(0) by the
  first element's size;
- field elements: little-endian, element_size bytes.
"""

from __future__ import annotations

import io
from typing import List

from ..merkle import BatchMerkleProof
from .proof import StarkProof
from .sizeof import MAX_ARRAY_LENGTH, size_of

_LEAF = 1
_NODE = 0


def _write_array(out: io.BytesIO, array: List[bytes]) -> None:
    out.write(bytes([0 if len(array) == MAX_ARRAY_LENGTH else len(array)]))
    for item in array:
        out.write(item)


def _write_matrix(out: io.BytesIO, matrix: List[List[bytes]], leaf_size: int) -> None:
    out.write(bytes([0 if len(matrix) == MAX_ARRAY_LENGTH else len(matrix)]))
    for column in matrix:
        col_type = _LEAF if (column and len(column[0]) == leaf_size) else _NODE
        out.write(bytes([(len(column) << 1) | col_type]))
    for column in matrix:
        for item in column:
            out.write(item)


def _write_merkle_proof(out: io.BytesIO, proof: BatchMerkleProof, leaf_size: int) -> None:
    _write_array(out, proof.values)
    _write_matrix(out, proof.nodes, leaf_size)
    out.write(bytes([proof.depth]))


class Serializer:
    def __init__(self, field, trace_register_count: int, secret_input_count: int,
                 hash_digest_size: int):
        self.field_element_size = field.element_size
        self.t_register_count = trace_register_count
        self.s_register_count = secret_input_count
        self.hash_digest_size = hash_digest_size

    def serialize_proof(self, proof: StarkProof) -> bytes:
        out = io.BytesIO()
        out.write(proof.ev_root)

        ev_leaf_size = (self.t_register_count + self.s_register_count) * \
            self.field_element_size
        _write_merkle_proof(out, proof.ev_proof, ev_leaf_size)

        ld_leaf_size = self.field_element_size * 4
        out.write(proof.ld_proof.lc_root)
        _write_merkle_proof(out, proof.ld_proof.lc_proof, ld_leaf_size)

        out.write(bytes([len(proof.ld_proof.components)]))
        for component in proof.ld_proof.components:
            out.write(component.column_root)
            _write_merkle_proof(out, component.column_proof, ld_leaf_size)
            _write_merkle_proof(out, component.poly_proof, ld_leaf_size)

        remainder_length = (0 if len(proof.ld_proof.remainder) == 256
                            else len(proof.ld_proof.remainder))
        out.write(bytes([remainder_length]))
        for value in proof.ld_proof.remainder:
            out.write(int(value).to_bytes(self.field_element_size, "little"))

        out.write(bytes([len(proof.i_shapes)]))
        for shape in proof.i_shapes:
            out.write(bytes([len(shape)]))
            for level in shape:
                out.write(int(level).to_bytes(4, "little"))

        data = out.getvalue()
        expected = size_of(proof, self.field_element_size, self.hash_digest_size)["total"]
        if len(data) != expected:
            raise ValueError(f"serializer size mismatch: {len(data)} != {expected}")
        return data
