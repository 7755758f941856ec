"""Byte-exact proof codec.

Counterpart of ``genstark_tpu/protocol/serializer.py`` (a copy: the write
side, and the read side `_read_array` :30, `_read_matrix` :50,
`_read_merkle_proof` :76 and `parse_proof` :129-181, which raises on a
malformed buffer what the JAX package raises):
- merkle-proof sublayout: array length u8 with 0 == 256; matrix of node
  columns with u8 `(len << 1) | type` headers, type = leaf(1)/node(0) by the
  first element's size;
- field elements: little-endian, element_size bytes.
"""

from __future__ import annotations

import io
from typing import List

from ..merkle import BatchMerkleProof
from .proof import FriComponent, LowDegreeProof, StarkProof
from .sizeof import MAX_ARRAY_LENGTH, size_of

_LEAF = 1
_NODE = 0


def _write_array(out: io.BytesIO, array: List[bytes]) -> None:
    out.write(bytes([0 if len(array) == MAX_ARRAY_LENGTH else len(array)]))
    for item in array:
        out.write(item)


def _read_array(buf: bytes, offset: int, element_size: int):
    n = buf[offset] or MAX_ARRAY_LENGTH
    offset += 1
    values = []
    for _ in range(n):
        values.append(buf[offset:offset + element_size])
        offset += element_size
    return values, offset


def _write_matrix(out: io.BytesIO, matrix: List[List[bytes]], leaf_size: int) -> None:
    out.write(bytes([0 if len(matrix) == MAX_ARRAY_LENGTH else len(matrix)]))
    for column in matrix:
        col_type = _LEAF if (column and len(column[0]) == leaf_size) else _NODE
        out.write(bytes([(len(column) << 1) | col_type]))
    for column in matrix:
        for item in column:
            out.write(item)


def _read_matrix(buf: bytes, offset: int, leaf_size: int, node_size: int):
    n_cols = buf[offset] or MAX_ARRAY_LENGTH
    offset += 1
    lengths, types = [], []
    for _ in range(n_cols):
        lt = buf[offset]
        offset += 1
        lengths.append(lt >> 1)
        types.append(lt & 1)
    matrix = []
    for i in range(n_cols):
        column = []
        for j in range(lengths[i]):
            size = (leaf_size if types[i] == _LEAF else node_size) if j == 0 else node_size
            column.append(buf[offset:offset + size])
            offset += size
        matrix.append(column)
    return matrix, offset


def _write_merkle_proof(out: io.BytesIO, proof: BatchMerkleProof, leaf_size: int) -> None:
    _write_array(out, proof.values)
    _write_matrix(out, proof.nodes, leaf_size)
    out.write(bytes([proof.depth]))


def _read_merkle_proof(buf: bytes, offset: int, leaf_size: int, node_size: int):
    values, offset = _read_array(buf, offset, leaf_size)
    nodes, offset = _read_matrix(buf, offset, leaf_size, node_size)
    depth = buf[offset]
    offset += 1
    return BatchMerkleProof(values=values, nodes=nodes, depth=depth), offset


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

    def parse_proof(self, buf: bytes) -> StarkProof:
        ds = self.hash_digest_size
        ev_root = buf[0:ds]
        offset = ds

        ev_leaf_size = (self.t_register_count + self.s_register_count) * \
            self.field_element_size
        ev_proof, offset = _read_merkle_proof(buf, offset, ev_leaf_size, ds)

        ld_leaf_size = self.field_element_size * 4
        lc_root = buf[offset:offset + ds]
        offset += ds
        lc_proof, offset = _read_merkle_proof(buf, offset, ld_leaf_size, ds)

        component_count = buf[offset]
        offset += 1
        components = []
        for _ in range(component_count):
            column_root = buf[offset:offset + ds]
            offset += ds
            column_proof, offset = _read_merkle_proof(buf, offset, ld_leaf_size, ds)
            poly_proof, offset = _read_merkle_proof(buf, offset, ld_leaf_size, ds)
            components.append(FriComponent(column_root=column_root,
                                           column_proof=column_proof,
                                           poly_proof=poly_proof))

        remainder_length = buf[offset] or MAX_ARRAY_LENGTH
        offset += 1
        remainder = []
        for _ in range(remainder_length):
            remainder.append(int.from_bytes(
                buf[offset:offset + self.field_element_size], "little"))
            offset += self.field_element_size

        input_count = buf[offset]
        offset += 1
        i_shapes = []
        for _ in range(input_count):
            rank = buf[offset]
            offset += 1
            shape = []
            for _ in range(rank):
                shape.append(int.from_bytes(buf[offset:offset + 4], "little"))
                offset += 4
            i_shapes.append(shape)

        if offset != len(buf):
            raise ValueError(
                f"proof buffer size mismatch: consumed {offset} of {len(buf)} bytes")
        return StarkProof(ev_root=ev_root, ev_proof=ev_proof,
                          ld_proof=LowDegreeProof(lc_root=lc_root, lc_proof=lc_proof,
                                                  components=components,
                                                  remainder=remainder),
                          i_shapes=i_shapes)
