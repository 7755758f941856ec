"""Byte-exact proof size prediction (must equal the serializer's output).

Counterpart of ``genstark_tpu/protocol/sizeof.py`` (a copy).
"""

from __future__ import annotations

MAX_ARRAY_LENGTH = 256
MAX_MATRIX_COLUMN_LENGTH = 127


def _size_of_array(array) -> int:
    if len(array) == 0:
        raise ValueError("Array cannot be zero-length")
    if len(array) > MAX_ARRAY_LENGTH:
        raise ValueError(f"Array length ({len(array)}) cannot exceed {MAX_ARRAY_LENGTH}")
    return 1 + sum(len(item) for item in array)


def _size_of_matrix(matrix) -> int:
    if len(matrix) > MAX_ARRAY_LENGTH:
        raise ValueError(
            f"Matrix column count ({len(matrix)}) cannot exceed {MAX_ARRAY_LENGTH}")
    size = 1 + len(matrix)
    for column in matrix:
        if len(column) >= MAX_MATRIX_COLUMN_LENGTH:
            raise ValueError(
                f"Matrix column length ({len(column)}) cannot exceed {MAX_MATRIX_COLUMN_LENGTH}")
        size += sum(len(item) for item in column)
    return size


def size_of_merkle_proof(proof) -> dict:
    values = _size_of_array(proof.values)
    nodes = _size_of_matrix(proof.nodes)
    return {"values": values, "nodes": nodes, "total": values + nodes + 1}


def size_of(proof, field_element_size: int, hash_digest_size: int) -> dict:
    size = hash_digest_size                       # evRoot

    ev_proof = size_of_merkle_proof(proof.ev_proof)
    size += ev_proof["total"]

    ld_proof = 1                                  # component count byte
    lc_proof = size_of_merkle_proof(proof.ld_proof.lc_proof)
    ld_proof += lc_proof["total"] + hash_digest_size

    ld_levels = []
    for component in proof.ld_proof.components:
        ld_proof += hash_digest_size
        column = size_of_merkle_proof(component.column_proof)
        ld_proof += column["total"]
        poly = size_of_merkle_proof(component.poly_proof)
        ld_proof += poly["total"]
        ld_levels.append({"column": column, "poly": poly,
                          "total": column["total"] + poly["total"] + hash_digest_size})

    ld_remainder = len(proof.ld_proof.remainder) * field_element_size + 1
    ld_levels.append({"total": ld_remainder})
    ld_proof += ld_remainder
    size += ld_proof

    input_shapes = 1
    for shape in proof.i_shapes:
        input_shapes += 1 + len(shape) * 4
    size += input_shapes

    return {"ev_proof": ev_proof,
            "ld_proof": {"lc_proof": lc_proof, "levels": ld_levels, "total": ld_proof},
            "input_shapes": input_shapes,
            "total": size}
