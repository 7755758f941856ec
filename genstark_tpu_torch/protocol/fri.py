"""Fold-by-4 FRI: the prover's device fold, the staged prover and host
checks.

Counterpart of ``genstark_tpu/protocol/fri.py``: `fold_traced` (:326-378)
on torch, `get_augmented_positions` (:50), the staged prover's
`LowDegreeProver` (`prove`, `_fri`, `_fold`, `_rows_bytes`, :60-150), the
remainder degree check of `LowDegreeProver.verify_remainder` (:275), which
both provers and the verifier share, and the host verifier of
`LowDegreeProver` (`verify` :152-231, `_check_quartics` :232 and the value
parsers :295-315) as `LowDegreeVerifier`.  The proof dataclasses are in
protocol/proof.py.

The fold needs no quartic interpolation: for a row with xs = {x, qx, -x,
-qx} (q a primitive 4th root of unity) the Lagrange evaluation at specialX
s is

    P(s) = inv4 * invx^3 * [ (s^2+x^2) (y0 (s+x) - y2 (s-x))
                           + invq (s^2-x^2) (y1 (s+qx) - y3 (s-qx)) ]
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import tracing
from ..field.limbs import limbs_to_ints
from ..merkle import BatchMerkleProof, MerkleTree
from .proof import FriComponent, LowDegreeProof

MAX_REMAINDER_LENGTH = 256


class StarkError(Exception):
    pass


def get_augmented_positions(positions: List[int], column_length: int) -> List[int]:
    """FRI-local augmentation: pos mod rowLength, insertion-ordered dedup."""
    row_length = column_length // 4
    out = dict()
    for p in positions:
        out[p % row_length] = True
    return list(out.keys())


def fold(dev, field, root_of_unity: int, domain_size: int, depth: int,
         values: torch.Tensor, c_s: torch.Tensor, c_s2: torch.Tensor,
         xtabs) -> torch.Tensor:
    """Quartic fold at `depth`: values [L, N] -> [L, N/4] with
    N = domain_size / 4^depth, row i of the output from the values at i,
    i + N/4, i + N/2, i + 3N/4.  c_s / c_s2: specialX and specialX^2 as
    [L, 1] Montgomery; xtabs: (x_tab, ix_tab) [L, N/4] tables of
    (w^(4^depth))^i and their inverses.  A rank of a mesh passes its rows'
    values as [L, 4 * rows] (protocol/sharded.py's stride transpose) and
    its rows of the tables.  Representation-preserving: every value
    multiply carries a Montgomery coefficient."""
    f = field.host
    M = values.shape[-1] // 4
    x, ix = xtabs
    q = f.exp(root_of_unity, domain_size // 4)       # primitive 4th root
    inv4 = f.inv(4)
    c_q = dev.const(q, shape=(1,))
    c4 = dev.const(inv4, shape=(1,))
    c4q = dev.const(f.mul(inv4, f.inv(q)), shape=(1,))

    y = values.reshape(dev.L, 4, M)
    y0, y1, y2, y3 = y[:, 0], y[:, 1], y[:, 2], y[:, 3]
    x2 = dev.mont_mul(x, x)
    qx = dev.mont_mul(c_q, x)
    s_plus_x = dev._add(c_s, x)
    s_minus_x = dev._sub(c_s, x)
    t02 = dev.mont_mul(dev._add(c_s2, x2),
                       dev._sub(dev.mont_mul(y0, s_plus_x),
                                dev.mont_mul(y2, s_minus_x)))
    t13 = dev.mont_mul(dev._sub(c_s2, x2),
                       dev._sub(dev.mont_mul(y3, dev._sub(c_s, qx)),
                                dev.mont_mul(y1, dev._add(c_s, qx))))
    ix3 = dev.mont_mul(dev.mont_mul(ix, ix), ix)
    acc = dev._add(dev.mont_mul(t02, c4), dev.mont_mul(t13, c4q))
    return dev.mont_mul(acc, ix3)


class LowDegreeProver:
    """The staged prover's FRI (JAX `LowDegreeProver`, fri.py:60-150): a
    tree a layer on the device (`MerkleTree.create`, its root fetched),
    specialX = prng(root) on the host, the fold on the device with
    per-depth power tables, the query positions drawn on the host from the
    fetched roots and each batch proof's digests and values fetched at
    once."""

    def __init__(self, idx_generator, hash_, context, logger=None):
        self.field = context.field
        self.context = context
        self.hash = hash_
        self.idx_generator = idx_generator
        self.log = logger or (lambda msg: None)

    def prove(self, l_evaluations: torch.Tensor, max_degree_plus1: int) -> LowDegreeProof:
        """l_evaluations: [L, Ne] Montgomery."""
        field = self.field
        dev = field.device_field(l_evaluations.device)
        Ne = l_evaluations.shape[-1]
        v_std = dev.from_mont(l_evaluations)
        p_tree = MerkleTree.create(self.hash.digest_stride_rows(v_std, field.element_size),
                                   self.hash)
        self.log("Built liner combination merkle tree")

        exe_positions = self.idx_generator.get_exe_indexes(p_tree.root, Ne)
        lc_positions = get_augmented_positions(exe_positions, Ne)
        lc_proof = p_tree.prove_batch(lc_positions)
        lc_proof.values = self._rows_bytes(v_std, lc_positions, Ne // 4)
        self.log(f"Computed {len(lc_positions)} linear combination spot checks")

        proof = LowDegreeProof(lc_root=p_tree.root, lc_proof=lc_proof, components=[],
                               remainder=[])
        self._fri(p_tree, l_evaluations, v_std, max_degree_plus1, 0, proof)
        return proof

    def _fri(self, p_tree: MerkleTree, values: torch.Tensor, v_std: torch.Tensor,
             max_degree_plus1: int, depth: int, proof: LowDegreeProof) -> None:
        field = self.field
        dev = field.device_field(values.device)
        N = values.shape[-1]
        if N <= MAX_REMAINDER_LENGTH:
            remainder = limbs_to_ints(tracing.fetch(v_std).numpy().astype(np.uint32))
            verify_remainder(field, self.idx_generator.extension_factor, remainder,
                             max_degree_plus1,
                             field.exp(self.context.root_of_unity, 4 ** depth))
            proof.remainder = remainder
            self.log(f"Computed FRI remainder of {len(remainder)} values")
            return

        column = self._fold(values, depth, field.prng(p_tree.root))       # [L, N/4]
        c_std = dev.from_mont(column)
        c_tree = MerkleTree.create(self.hash.digest_stride_rows(c_std, field.element_size),
                                   self.hash)
        self.log(f"Computed FRI layer at depth {depth}")

        self._fri(c_tree, column, c_std, max_degree_plus1 // 4, depth + 1, proof)

        column_length = N // 4
        positions = self.idx_generator.get_fri_indexes(c_tree.root, column_length)
        augmented = get_augmented_positions(positions, column_length)
        column_proof = c_tree.prove_batch(augmented)
        column_proof.values = self._rows_bytes(c_std, augmented, column_length // 4)
        poly_proof = p_tree.prove_batch(positions)
        poly_proof.values = self._rows_bytes(v_std, positions, N // 4)
        proof.components.insert(0, FriComponent(column_root=c_tree.root,
                                                column_proof=column_proof,
                                                poly_proof=poly_proof))

    def verify(self, proof, lc_values: List[int], exe_positions: List[int],
               max_degree_plus1: int) -> bool:
        """The JAX `LowDegreeProver.verify` (fri.py:152): `LowDegreeVerifier`'s."""
        return LowDegreeVerifier(self.idx_generator, self.hash, self.context).verify(
            proof, lc_values, exe_positions, max_degree_plus1)

    def verify_remainder(self, remainder: List[int], max_degree_plus1: int,
                         root_of_unity: int) -> None:
        """The JAX `LowDegreeProver.verify_remainder` (fri.py:275): the
        module's `verify_remainder` at this prover's extension factor."""
        verify_remainder(self.field, self.idx_generator.extension_factor, remainder,
                         max_degree_plus1, root_of_unity)

    def _fold(self, values: torch.Tensor, depth: int, special_x: int) -> torch.Tensor:
        """`fold` at `depth` with specialX from the host and the layer's
        tables (w^(4^depth))^i and their inverses as power series: the JAX
        staged fold's values (fri.py:318-323 gathers them from full-domain
        series), with no full-domain table."""
        field = self.field
        f = field.host
        dev = field.device_field(values.device)
        rou = self.context.root_of_unity
        Ne = self.context.evaluation_domain_size
        g = f.exp(rou, 4 ** depth)
        m = values.shape[-1] // 4
        c_s, c_s2 = (dev.from_ints([v]) for v in (special_x, f.mul(special_x, special_x)))
        return fold(dev, field, rou, Ne, depth, values, c_s, c_s2,
                    (dev.power_series(g, m), dev.power_series(f.inv(g), m)))

    def _rows_bytes(self, v_std: torch.Tensor, rows: List[int], row_count: int) -> List[bytes]:
        """Bytes of stride rows r: elements r, r+M, r+2M, r+3M (LE), all
        rows gathered and fetched at once."""
        elem = self.field.element_size
        idx = tracing.upload([r + j * row_count for r in rows for j in range(4)], torch.int64,
                             v_std.device)
        ints = limbs_to_ints(tracing.fetch(v_std.index_select(1, idx)).numpy().astype(np.uint32))
        return [b"".join(v.to_bytes(elem, "little") for v in ints[4 * i:4 * i + 4])
                for i in range(len(rows))]


def verify_remainder(field, extension_factor: int, remainder: List[int],
                     max_degree_plus1: int, root_of_unity: int) -> None:
    """Exclude extension-factor multiples, interpolate maxDegreePlus1 of
    the rest, check every other point (raises StarkError)."""
    f = field.host
    ext = extension_factor
    positions = [i for i in range(len(remainder)) if not ext or i % ext]
    if max_degree_plus1 > len(positions):
        raise StarkError("Remainder degree is greater than number of remainder values")
    domain = f.get_power_series(root_of_unity, len(remainder))
    xs = [domain[positions[i]] for i in range(max_degree_plus1)]
    ys = [remainder[positions[i]] for i in range(max_degree_plus1)]
    poly = f.interpolate(xs, ys)
    for i in range(max_degree_plus1, len(positions)):
        p = positions[i]
        if f.eval_poly_at(poly, domain[p]) != remainder[p]:
            raise StarkError(
                f"Remainder is not a valid degree {max_degree_plus1 - 1} polynomial")


def rehashed(proof: BatchMerkleProof, hash_) -> BatchMerkleProof:
    """The proof with its raw leaf bytes replaced by their digests."""
    return BatchMerkleProof(values=[hash_.digest(v) for v in proof.values],
                            nodes=proof.nodes, depth=proof.depth)


class LowDegreeVerifier:
    """The host verifier of a fold-by-4 FRI proof (raises StarkError)."""

    def __init__(self, idx_generator, hash_, context):
        self.field = context.field
        self.context = context
        self.hash = hash_
        self.idx_generator = idx_generator

    def verify(self, proof, lc_values: List[int], exe_positions: List[int],
               max_degree_plus1: int) -> bool:
        field = self.field
        f = field.host
        hash_ = self.hash
        root_of_unity = self.context.root_of_unity
        column_length = self.context.evaluation_domain_size

        quartic_roots = [1,
                         f.exp(root_of_unity, column_length // 4),
                         f.exp(root_of_unity, column_length // 2),
                         f.exp(root_of_unity, column_length * 3 // 4)]

        # 1 ----- linear combination correctness
        lc_positions = get_augmented_positions(exe_positions, column_length)
        lc_checks = self._parse_column_values(proof.lc_proof.values, exe_positions,
                                              lc_positions, column_length)
        if not MerkleTree.verify_batch(proof.lc_root, lc_positions,
                                       rehashed(proof.lc_proof, hash_), hash_):
            raise StarkError("Verification of linear combination Merkle proof failed")
        for got, want in zip(lc_values, lc_checks):
            if got != want:
                raise StarkError("Verification of linear combination correctness failed")

        # 2 ----- recursive components
        p_root = proof.lc_root
        column_length //= 4
        for depth, component in enumerate(proof.components):
            positions = self.idx_generator.get_fri_indexes(component.column_root,
                                                           column_length)
            augmented = get_augmented_positions(positions, column_length)

            column_values = self._parse_column_values(component.column_proof.values,
                                                      positions, augmented,
                                                      column_length)
            if not MerkleTree.verify_batch(component.column_root, augmented,
                                           rehashed(component.column_proof, hash_),
                                           hash_):
                raise StarkError(f"Verification of column Merkle proof failed at depth {depth}")

            poly_values = self._parse_poly_values(component.poly_proof.values)
            if not MerkleTree.verify_batch(p_root, positions,
                                           rehashed(component.poly_proof, hash_), hash_):
                raise StarkError(f"Verification of polynomial Merkle proof failed at depth {depth}")

            special_x = field.prng(p_root)
            self._check_quartics(f, root_of_unity, quartic_roots, positions,
                                 poly_values, column_values, special_x, depth)

            p_root = component.column_root
            root_of_unity = f.exp(root_of_unity, 4)
            max_degree_plus1 //= 4
            column_length //= 4

        # 3 ----- remainder
        if max_degree_plus1 > len(proof.remainder):
            raise StarkError("Remainder degree is greater than number of remainder values")
        # re-commit the remainder and compare to the last layer root
        m = len(proof.remainder) // 4
        elem = field.element_size
        row_buffers = [b"".join(int(proof.remainder[r + j * m]).to_bytes(
            elem, "little") for j in range(4)) for r in range(m)]
        c_tree = MerkleTree.create_from_bytes([hash_.digest(b) for b in row_buffers], hash_)
        if c_tree.root != p_root:
            raise StarkError("Remainder values do not match Merkle root of the last column")

        verify_remainder(field, self.idx_generator.extension_factor, proof.remainder,
                         max_degree_plus1, root_of_unity)
        return True

    @staticmethod
    def _check_quartics(f, w, quartic_roots, positions, poly_values,
                        column_values, special_x, depth) -> None:
        """The per-query degree-4 check in closed form: the interpolation
        points are the 4 roots of x^4 = xe^4, so with N(x) = x^4 - xe^4 and
        N'(x_j) = 4 x_j^3,  P(x*) = N(x*) * sum_j y_j / (4 x_j^3 (x* - x_j)).
        All denominators of a layer invert in one batch."""
        p = f.p
        c4 = [4 * pow(r, 3, p) % p for r in quartic_roots]
        sx4 = pow(special_x, 4, p)
        dens: List[int] = []
        rows = []
        for position in positions:
            xe = f.exp(w, position)
            xe3 = xe * xe % p * xe % p
            nx = (sx4 - xe3 * xe) % p                     # N(x*) = x*^4 - xe^4
            for j, r in enumerate(quartic_roots):
                dens.append(c4[j] * xe3 % p * ((special_x - r * xe) % p) % p)
            rows.append(nx)
        try:
            invs = f.batch_inv(dens)
        except ZeroDivisionError:
            # special_x collided with an interpolation point: generic fallback
            for i, position in enumerate(positions):
                xe = f.exp(w, position)
                xs = [f.mul(qr, xe) for qr in quartic_roots]
                poly = f.interpolate(xs, poly_values[i])
                if f.eval_poly_at(poly, special_x) != column_values[i]:
                    raise StarkError(
                        f"Degree 4 polynomial didn't evaluate to column value at depth {depth}")
            return
        for i in range(len(positions)):
            acc = 0
            for j in range(4):
                acc = (acc + poly_values[i][j] * invs[4 * i + j]) % p
            if rows[i] * acc % p != column_values[i]:
                raise StarkError(
                    f"Degree 4 polynomial didn't evaluate to column value at depth {depth}")

    def _parse_poly_values(self, buffers: List[bytes]) -> List[List[int]]:
        elem = self.field.element_size
        return [[int.from_bytes(buf[i * elem:(i + 1) * elem], "little") for i in range(4)]
                for buf in buffers]

    def _parse_column_values(self, buffers: List[bytes], positions: List[int],
                             augmented_positions: List[int],
                             column_length: int) -> List[int]:
        row_length = column_length // 4
        elem = self.field.element_size
        out = []
        for position in positions:
            idx = augmented_positions.index(position % row_length)
            buf = buffers[idx]
            offset = (position // row_length) * elem
            out.append(int.from_bytes(buf[offset:offset + elem], "little"))
        return out
