"""The plain reference that judges a serialized proof: a STARK verifier of
genSTARK's protocol (fold-by-4 FRI, sha256-counter transcript, batched
Merkle proofs, the proof codec) over Python ints and hashlib.

It imports nothing of the program.  It takes the configuration's frozen
AIR (`air.Air`), the options the configuration states and the statement
the benchmark made (assertions, input shapes, public inputs), parses the
proof's bytes itself and checks every part of them: the evaluation
commitment and its spot checks, the composition polynomial and the linear
combination at every queried position, every FRI layer's column and
polynomial commitments and quartic checks, the remainder against its
commitment and its degree, the query positions drawn from the transcript,
and that the bytes hold exactly this layout.  `verify` returns None or
raises `Reject` with the first check that failed.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Sequence

MAX_REMAINDER_LENGTH = 256
MAX_ARRAY_LENGTH = 256
DIGEST = 32


class Reject(Exception):
    """The proof does not verify; the message names the failed check."""


def _digest(algorithm: str):
    if algorithm == "blake2s256":
        return lambda data: hashlib.blake2s(data).digest()
    if algorithm == "sha256":
        return lambda data: hashlib.sha256(data).digest()
    raise ValueError(f"hash algorithm {algorithm} is not supported")


# ----------------------------------------------------------------------- codec
@dataclass
class MerkleBatch:
    values: List[bytes]
    nodes: List[List[bytes]]
    depth: int


class _Reader:
    def __init__(self, buf: bytes):
        self.buf, self.at = buf, 0

    def take(self, n: int) -> bytes:
        if self.at + n > len(self.buf):
            raise Reject("proof bytes end early")
        out = self.buf[self.at:self.at + n]
        self.at += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def merkle(self, leaf_size: int) -> MerkleBatch:
        values = [self.take(leaf_size) for _ in range(self.byte() or MAX_ARRAY_LENGTH)]
        headers = [self.byte() for _ in range(self.byte() or MAX_ARRAY_LENGTH)]
        nodes = []
        for h in headers:
            column = []
            for j in range(h >> 1):
                column.append(self.take(leaf_size if (h & 1 and j == 0) else DIGEST))
            nodes.append(column)
        return MerkleBatch(values, nodes, self.byte())


def parse(buf: bytes, leaf_size: int, element_size: int) -> dict:
    r = _Reader(buf)
    proof = {"ev_root": r.take(DIGEST), "ev": r.merkle(leaf_size),
             "lc_root": r.take(DIGEST), "lc": r.merkle(4 * element_size), "layers": []}
    for _ in range(r.byte()):
        proof["layers"].append((r.take(DIGEST), r.merkle(4 * element_size),
                                r.merkle(4 * element_size)))
    proof["remainder"] = [int.from_bytes(r.take(element_size), "little")
                          for _ in range(r.byte() or MAX_ARRAY_LENGTH)]
    shapes = []
    for _ in range(r.byte()):
        shapes.append([int.from_bytes(r.take(4), "little") for _ in range(r.byte())])
    proof["shapes"] = shapes
    if r.at != len(buf):
        raise Reject(f"proof has {len(buf) - r.at} trailing bytes")
    return proof


# ---------------------------------------------------------------------- merkle
def merkle_verify(root: bytes, positions: Sequence[int], batch: MerkleBatch,
                  depth: int, digest) -> bool:
    """A batched authentication walk; the leaves are hashed first."""
    if batch.depth != depth or len(positions) != len(batch.values):
        return False
    if len(set(positions)) != len(positions) or len(batch.nodes) != len(positions):
        return False
    level = {}
    for p, v in zip(positions, batch.values):
        if not 0 <= p < 1 << depth:
            return False
        level[p] = digest(v)
    cursors = [0] * len(positions)
    for lvl in range(depth):
        done, parents = set(), {}
        for ci, p in enumerate(positions):
            idx = p >> lvl
            if idx in done or idx ^ 1 in done:
                continue
            done.add(idx)
            sib = idx ^ 1
            if sib not in level:
                if cursors[ci] >= len(batch.nodes[ci]):
                    return False
                level[sib] = batch.nodes[ci][cursors[ci]]
                cursors[ci] += 1
            a, b = level[idx], level[sib]
            parents[idx >> 1] = digest(a + b if idx % 2 == 0 else b + a)
        level = parents
    if any(c != len(col) for c, col in zip(cursors, batch.nodes)):
        return False
    return level.get(0) == root


# --------------------------------------------------------------------- queries
def _sha256_int(value) -> int:
    if isinstance(value, int):
        text = format(value, "x")
        data = bytes.fromhex(text[:len(text) - len(text) % 2])   # an odd last nibble is dropped
    else:
        data = value
    return int.from_bytes(hashlib.sha256(data).digest(), "big")


def query_positions(seed: bytes, count: int, max_: int, exclude: int) -> List[int]:
    """The transcript's query positions: distinct sha256(state + i) mod max_,
    skipping multiples of `exclude`, in draw order."""
    found: Dict[int, None] = {}
    state = _sha256_int(seed)
    for i in range(count * 1000):
        index = _sha256_int(state + i) % max_
        if index % exclude and index not in found:
            found[index] = None
            if len(found) == count:
                return list(found)
    raise Reject("query positions could not be drawn")


def _dedup(values) -> List[int]:
    return list(dict.fromkeys(values))


# ------------------------------------------------------------------------ main
def verify(air, options: dict, statement, buf: bytes) -> None:
    """Judge `buf` as a proof of `statement` under `options`; raises Reject."""
    f, p = air.field, air.field.p
    digest = _digest(options["hash_algorithm"])
    ext = options["extension_factor"]
    elem = f.element_size
    V = air.trace_width + air.secret_count
    proof = parse(buf, V * elem, elem)
    if proof["shapes"] != statement.shapes:
        raise Reject("the proof's input shapes are not the statement's")
    ctx = air.context(statement.shapes, statement.public)
    T = ctx.trace_length
    Ne = T * ext
    rou = f.root_of_unity(Ne)

    # composition structure and transcript coefficients
    degrees = air.degrees
    max_degree = max(degrees)
    combination = (1 << (max_degree - 1).bit_length() if max_degree > 1 else 1) * T
    composition = max(combination - T, T)
    groups: Dict[int, List[int]] = {}
    for i, d in enumerate(degrees):
        groups.setdefault(d * T, []).append(i)
    boundary: Dict[int, dict] = {}
    for step, register, value in statement.assertions:
        x = pow(rou, step * ext, p)
        b = boundary.setdefault(register, {"xs": [], "ys": []})
        b["xs"].append(x)
        b["ys"].append(value % p)
    for b in boundary.values():
        b["i_poly"] = f.interpolate(b["xs"], b["ys"])
    n_d = len(degrees) + sum(len(ix) for d, ix in groups.items() if d < combination)
    n_b = len(boundary) * (2 if composition > T else 1)
    ps_incr = composition - T
    n_l = V * (2 if ps_incr > 0 else 1)
    stream = f.prng(proof["ev_root"], n_d + n_b + n_l)
    d_coef, b_coef, l_coef = stream[:n_d], stream[n_d:n_d + n_b], stream[n_d + n_b:]

    # evaluation spot checks
    positions = query_positions(proof["lc_root"], min(options["exe_query_count"], Ne - Ne // ext),
                                Ne, ext)
    augmented = _dedup(q for pos in positions for q in (pos, (pos + ext) % Ne))
    ev = proof["ev"]
    if not merkle_verify(proof["ev_root"], augmented, ev, Ne.bit_length() - 1, digest):
        raise Reject("evaluation Merkle proof")
    leaves = {pos: [int.from_bytes(v[i * elem:(i + 1) * elem], "little") for i in range(V)]
              for pos, v in zip(augmented, ev.values)}

    # C(x) and L(x) at every position
    x_last = pow(rou, (T - 1) * ext, p)
    xs = [pow(rou, pos, p) for pos in positions]
    dens = []
    for x in xs:
        dens.append((pow(x, T, p) - 1) % p)
        for b in boundary.values():
            z = 1
            for r in b["xs"]:
                z = z * (x - r) % p
            dens.append(z)
    invs = f.batch_inv(dens)
    per = 1 + len(boundary)
    lc_values = []
    for i, pos in enumerate(positions):
        x = xs[i]
        cur, nxt = leaves[pos], leaves[(pos + ext) % Ne]
        trace, secret = cur[:air.trace_width], cur[air.trace_width:]
        q = ctx.constraints_at(x, trace, nxt[:air.trace_width], secret)
        for d, ix in groups.items():
            if d != combination:
                power = pow(x, combination - d, p)
                q.extend(q[j] * power % p for j in ix)
        qc = sum(v * c for v, c in zip(q, d_coef)) % p
        z_inv = (x - x_last) * invs[i * per] % p
        bv = [(trace[reg] - f.eval_poly(b["i_poly"], x)) * invs[i * per + 1 + k] % p
              for k, (reg, b) in enumerate(boundary.items())]
        if composition > T:
            power = pow(x, composition - T, p)
            bv += [v * power % p for v in bv]
        c_value = (qc * z_inv + sum(v * c for v, c in zip(bv, b_coef))) % p
        ps = list(cur)
        if ps_incr > 0:
            power = pow(x, ps_incr, p)
            ps += [v * power % p for v in cur]
        lc_values.append((c_value + sum(v * c for v, c in zip(ps, l_coef))) % p)

    _verify_fri(f, options, digest, proof, rou, Ne, positions, lc_values, composition)


def _column_values(batch: MerkleBatch, positions, augmented, column_length, elem):
    rows = column_length // 4
    out = []
    for pos in positions:
        buf = batch.values[augmented.index(pos % rows)]
        at = (pos // rows) * elem
        out.append(int.from_bytes(buf[at:at + elem], "little"))
    return out


def _verify_fri(f, options, digest, proof, rou, Ne, exe_positions, lc_values,
                max_degree_plus1) -> None:
    p, elem, ext = f.p, f.element_size, options["extension_factor"]
    layer_count, n = 0, Ne
    while n > MAX_REMAINDER_LENGTH:
        layer_count += 1
        n //= 4
    if len(proof["layers"]) != layer_count or len(proof["remainder"]) != n:
        raise Reject("FRI layer count or remainder length")

    column_length = Ne
    lc_positions = _dedup(pos % (Ne // 4) for pos in exe_positions)
    if not merkle_verify(proof["lc_root"], lc_positions, proof["lc"],
                         (Ne // 4).bit_length() - 1, digest):
        raise Reject("linear combination Merkle proof")
    if _column_values(proof["lc"], exe_positions, lc_positions, Ne, elem) != lc_values:
        raise Reject("linear combination values")

    p_root = proof["lc_root"]
    column_length //= 4
    for depth, (column_root, column, poly) in enumerate(proof["layers"]):
        positions = query_positions(column_root, options["fri_query_count"], column_length, ext)
        augmented = _dedup(pos % (column_length // 4) for pos in positions)
        if not merkle_verify(column_root, augmented, column,
                             (column_length // 4).bit_length() - 1, digest):
            raise Reject(f"FRI column Merkle proof at depth {depth}")
        if not merkle_verify(p_root, positions, poly, column_length.bit_length() - 1, digest):
            raise Reject(f"FRI polynomial Merkle proof at depth {depth}")
        column_values = _column_values(column, positions, augmented, column_length, elem)
        special_x = f.prng(p_root, 1)[0]
        quartic = [pow(rou, k * column_length, p) for k in range(4)]   # 4th roots of 1
        for i, pos in enumerate(positions):
            xe = pow(rou, pos, p)
            ys = [int.from_bytes(poly.values[i][j * elem:(j + 1) * elem], "little")
                  for j in range(4)]
            coeffs = f.interpolate([q * xe % p for q in quartic], ys)
            if f.eval_poly(coeffs, special_x) != column_values[i]:
                raise Reject(f"FRI quartic check at depth {depth}")
        p_root = column_root
        rou = pow(rou, 4, p)
        max_degree_plus1 //= 4
        column_length //= 4

    remainder = proof["remainder"]
    m = len(remainder) // 4
    rows = [digest(b"".join(remainder[r + j * m].to_bytes(elem, "little") for j in range(4)))
            for r in range(m)]
    while len(rows) > 1:
        rows = [digest(rows[i] + rows[i + 1]) for i in range(0, len(rows), 2)]
    if rows[0] != p_root:
        raise Reject("remainder against the last layer's root")
    points = [i for i in range(len(remainder)) if i % ext]
    if max_degree_plus1 > len(points):
        raise Reject("remainder degree above its point count")
    xs = [pow(rou, i, p) for i in points]
    coeffs = f.interpolate(xs[:max_degree_plus1],
                           [remainder[i] for i in points[:max_degree_plus1]])
    for x, i in zip(xs[max_degree_plus1:], points[max_degree_plus1:]):
        if f.eval_poly(coeffs, x) != remainder[i]:
            raise Reject("remainder degree")
