"""Standalone AirAssembly standard library.

Counterpart of ``genstark_tpu/stdlib/__init__.py`` (a copy: it emits the
same program text).  Generates the framework's own lib128/lib224
AirAssembly sources — the Poseidon hash, Merkle-root, Merkle-update and
(224-bit) Schnorr-signature components whose behavioral spec is the
reference's stdlib (its assembly/lib128.aa:81-199 and lib224.aa:143-431).  Nothing
is read from the reference at runtime: every constant is re-derived here
(Cauchy MDS matrix, "Hades<i>" PRNG seeds, the full/partial round schedule,
the secp224r1 curve constant), and the program text is emitted by this
module, parametric over the Poseidon state width and leaf arity.

Semantics notes (kept identical so traces/oracles agree across sources):
- Poseidon: 8 full + 55 partial rounds, S-box x^5, 64 steps; partial rounds
  apply the S-box to the LAST state element only.
- merkle transition, lib128 flavor: the leaf-mask branch re-initializes
  with the OVERLAPPING slices (k0,k1)/(k1,k2) — this mirrors the reference
  exactly (lib128.aa:66); the value only reaches constraints at input-mask
  wrap rows, but it does reach them, so it must match.
- Schnorr: double-and-add of s*G and h*P sharing one 256-step trace, with
  in-trace slopes checked by the evaluation constraints (18 = 14 register
  constraints + 2 bit-binarity + 2 padding).
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import List

P128 = 2 ** 128 - 9 * 2 ** 32 + 1
P224 = 2 ** 224 - 2 ** 96 + 1

F_ROUNDS, P_ROUNDS, STEPS = 8, 55, 64


def _hades_scalars(p: int, tag: str, count: int) -> List[int]:
    return [int.from_bytes(hashlib.sha256(f"{tag}{i}".encode()).digest(),
                           "big") % p for i in range(count)]


def cauchy_mds(p: int, width: int) -> List[List[int]]:
    """mds[i][j] = 1/(x_i - y_j) over GF(p), x/y from the Hades seeds (the
    reference's getMdsMatrix, examples/poseidon/utils.ts:64-79)."""
    xs = _hades_scalars(p, "HadesMDSx", width)
    ys = _hades_scalars(p, "HadesMDSy", width)
    if len(set(xs + ys)) != 2 * width:
        raise ValueError("MDS seed values collide")
    return [[pow((xi - yj) % p, p - 2, p) for yj in ys] for xi in xs]


def round_schedule(steps: int = STEPS) -> List[int]:
    """1 = full round, 0 = partial, zero-padded to `steps`."""
    half = F_ROUNDS // 2
    out = [1 if (i < half or i >= half + P_ROUNDS) else 0
           for i in range(F_ROUNDS + P_ROUNDS)]
    return out + [0] * (steps - len(out))


def _key_cycles(width: int) -> str:
    lines = []
    for j in range(1, width + 1):
        seed_hex = f"Hades{j}".encode().hex()
        lines.append(f"            (cycle (prng sha256 0x{seed_hex} {STEPS}))")
    return "\n".join(lines)


def _mds_const(p: int, width: int) -> str:
    rows = cauchy_mds(p, width)
    body = "\n".join("        (" + " ".join(str(v) for v in row) + ")"
                     for row in rows)
    return f"    (const $mds matrix\n{body})"


def _schedule_cycle() -> str:
    return ("            (cycle " +
            " ".join(str(b) for b in round_schedule()) + ")")


def _poseidon_round(width: int) -> str:
    w1 = width - 1
    return f"""    (function $round
        (result vector {width})
        (param $st vector {width}) (param $rk vector {width}) (param $full scalar)
        (local $fr vector {width}) (local $pr vector {width})
        (store.local $fr
            (prod (load.const $mds)
                  (exp (add (load.param $st) (load.param $rk)) (scalar 5))))
        (store.local $pr
            (prod (load.const $mds)
                  (vector
                      (add (slice (load.param $st) 0 {w1 - 1})
                           (slice (load.param $rk) 0 {w1 - 1}))
                      (exp (add (get (load.param $st) {w1})
                                (get (load.param $rk) {w1}))
                           (scalar 5)))))
        (add (mul (load.local $fr) (load.param $full))
             (mul (load.local $pr) (sub (scalar 1) (load.param $full)))))"""


# ------------------------------------------------------------------ lib128

def _lib128_merkle_fns() -> str:
    # leaf values are 2-wide; the dual-lane state hashes H(p,v) and H(v,p)
    return """    (function $hashInit
        (result vector 12)
        (param $p vector 2) (param $v vector 2)
        (vector (load.param $p) (load.param $v) (scalar 0) (scalar 0)
                (load.param $v) (load.param $p) (scalar 0) (scalar 0)))

    (function $merkleStep
        (result vector 12)
        (param $r vector 12) (param $k vector 14)
        (local $a vector 6) (local $b vector 6) (local $sel vector 2)
        (store.local $a
            (call $round (slice (load.param $r) 0 5)
                         (slice (load.param $k) 8 13)
                         (get (load.param $k) 7)))
        (store.local $b
            (call $round (slice (load.param $r) 6 11)
                         (slice (load.param $k) 8 13)
                         (get (load.param $k) 7)))
        (store.local $sel
            (add (mul (slice (load.param $r) 6 7) (get (load.param $k) 4))
                 (mul (slice (load.param $r) 0 1)
                      (sub (scalar 1) (get (load.param $k) 4)))))
        (add
            (mul (call $hashInit (slice (load.param $k) 0 1)
                                 (slice (load.param $k) 1 2))
                 (get (load.param $k) 5))
            (add
                (mul (call $hashInit (load.local $sel)
                                     (slice (load.param $k) 2 3))
                     (mul (sub (scalar 1) (get (load.param $k) 5))
                          (get (load.param $k) 6)))
                (mul (vector (load.local $a) (load.local $b))
                     (mul (sub (scalar 1) (get (load.param $k) 5))
                          (sub (scalar 1) (get (load.param $k) 6)))))))"""


def _lib128_exports() -> str:
    kc = _key_cycles(6)
    sc = _schedule_cycle()
    return f"""    (export ComputePoseidonHash
        (registers 6) (constraints 6) (steps {STEPS})
        (static
            (input secret (steps {STEPS}) (shift -1))
            (input secret (steps {STEPS}) (shift -1))
            (input secret (steps {STEPS}) (shift -1))
            (input secret (steps {STEPS}) (shift -1))
            (mask (input 0))
{sc}
{kc})
        (init
            (vector (slice (load.static 0) 0 3) (scalar 0) (scalar 0)))
        (transition
            (local vector 6)
            (store.local 0
                (call $round (load.trace 0) (slice (load.static 0) 6 11)
                             (get (load.static 0) 5)))
            (add
                (mul (vector (slice (load.static 0) 0 3) (scalar 0) (scalar 0))
                     (get (load.static 0) 4))
                (mul (load.local 0) (sub (scalar 1) (get (load.static 0) 4)))))
        (evaluation
            (local vector 6)
            (store.local 0
                (call $round (load.trace 0) (slice (load.static 0) 6 11)
                             (get (load.static 0) 5)))
            (sub (load.trace 1)
                 (add
                     (mul (vector (slice (load.static 0) 0 3) (scalar 0) (scalar 0))
                          (get (load.static 0) 4))
                     (mul (load.local 0)
                          (sub (scalar 1) (get (load.static 0) 4)))))))

    (export ComputeMerkleRoot
        (registers 12) (constraints 12) (steps {STEPS})
        (static
            (input secret (shift -1))
            (input secret (peerof 0) (shift -1))
            (input secret (childof 0) (steps {STEPS}) (shift -1))
            (input secret (childof 0) (steps {STEPS}) (shift -1))
            (input public (childof 0) (steps {STEPS}) (shift -1))
            (mask (input 0))
            (mask (input 2))
{sc}
{kc})
        (init
            (call $hashInit (slice (load.static 0) 0 1) (slice (load.static 0) 2 3)))
        (transition
            (call $merkleStep (load.trace 0) (load.static 0)))
        (evaluation
            (sub (load.trace 1)
                 (call $merkleStep (load.trace 0) (load.static 0)))))

    (export ComputeMerkleUpdate
        (registers 24) (constraints 25) (steps {STEPS})
        (static
            (input secret (shift -1))
            (input secret (peerof 0) (shift -1))
            (input secret (peerof 0) (shift -1))
            (input secret (peerof 0) (shift -1))
            (input secret (childof 0) (steps {STEPS}) (shift -1))
            (input secret (childof 0) (steps {STEPS}) (shift -1))
            (input secret (childof 0) (steps {STEPS}) (shift -1))
            (mask (input 0))
            (mask (input 4))
{sc}
{kc})
        (init
            (vector
                (call $hashInit (slice (load.static 0) 0 1) (slice (load.static 0) 4 5))
                (call $hashInit (slice (load.static 0) 2 3) (slice (load.static 0) 4 5))))
        (transition
            (vector
                (call $merkleStep (slice (load.trace 0) 0 11)
                      (vector (slice (load.static 0) 0 1) (slice (load.static 0) 4 15)))
                (call $merkleStep (slice (load.trace 0) 12 23)
                      (vector (slice (load.static 0) 2 3) (slice (load.static 0) 4 15)))))
        (evaluation
            (local $t vector 24)
            (store.local $t
                (vector
                    (call $merkleStep (slice (load.trace 0) 0 11)
                          (vector (slice (load.static 0) 0 1) (slice (load.static 0) 4 15)))
                    (call $merkleStep (slice (load.trace 0) 12 23)
                          (vector (slice (load.static 0) 2 3) (slice (load.static 0) 4 15)))))
            (vector
                (sub (load.trace 1) (load.local $t))
                (sub (exp (get (load.static 0) 6) (scalar 2))
                     (get (load.static 0) 6)))))"""


@lru_cache(maxsize=None)
def lib128_source() -> str:
    """The 128-bit stdlib: ComputePoseidonHash (6 regs), ComputeMerkleRoot
    (12), ComputeMerkleUpdate (24), all 64 steps over p = 2^128 - 9*2^32 + 1."""
    return "\n\n".join([
        "(module",
        f"    (field prime {P128})",
        _mds_const(P128, 6),
        _poseidon_round(6),
        _lib128_merkle_fns(),
        _lib128_exports(),
        ")"])


# ------------------------------------------------------------------ lib224

def _lib224_merkle_fns() -> str:
    # scalar leaves; dual-lane 3-wide states
    return """    (function $hashInit
        (result vector 6)
        (param $p scalar) (param $v scalar)
        (vector (load.param $p) (load.param $v) (scalar 0)
                (load.param $v) (load.param $p) (scalar 0)))

    (function $merkleStep
        (result vector 6)
        (param $r vector 6) (param $k vector 9)
        (local $a vector 3) (local $b vector 3) (local $sel scalar)
        (store.local $a
            (call $round (slice (load.param $r) 0 2)
                         (slice (load.param $k) 6 8)
                         (get (load.param $k) 5)))
        (store.local $b
            (call $round (slice (load.param $r) 3 5)
                         (slice (load.param $k) 6 8)
                         (get (load.param $k) 5)))
        (store.local $sel
            (add (mul (get (load.param $r) 3) (get (load.param $k) 2))
                 (mul (get (load.param $r) 0)
                      (sub (scalar 1) (get (load.param $k) 2)))))
        (add
            (mul (call $hashInit (get (load.param $k) 0) (get (load.param $k) 1))
                 (get (load.param $k) 3))
            (add
                (mul (call $hashInit (load.local $sel) (get (load.param $k) 1))
                     (mul (sub (scalar 1) (get (load.param $k) 3))
                          (get (load.param $k) 4)))
                (mul (vector (load.local $a) (load.local $b))
                     (mul (sub (scalar 1) (get (load.param $k) 3))
                          (sub (scalar 1) (get (load.param $k) 4)))))))"""


def _lib224_ec_fns() -> str:
    # secp224r1 short-Weierstrass arithmetic in-trace: add via slope m,
    # doubling slope from the curve equation (a = p - 3)
    return """    (function $ecAdd
        (result vector 2)
        (param $p vector 2) (param $q vector 2) (param $m scalar)
        (local $x scalar) (local $y scalar)
        (store.local $x
            (sub (exp (load.param $m) (scalar 2))
                 (add (get (load.param $p) 0) (get (load.param $q) 0))))
        (store.local $y
            (sub (mul (load.param $m)
                      (sub (get (load.param $p) 0) (load.local $x)))
                 (get (load.param $p) 1)))
        (vector (load.local $x) (load.local $y)))

    (function $dblSlope
        (result scalar)
        (param $p vector 2)
        (div (add (mul (scalar 3) (exp (get (load.param $p) 0) (scalar 2)))
                  (load.const $a))
             (mul (scalar 2) (get (load.param $p) 1))))

    (function $accStep
        (result vector 2)
        (param $p vector 2) (param $q vector 2) (param $m scalar) (param $k vector 2)
        (add
            (mul (load.param $q)
                 (sub (scalar 1) (get (load.param $k) 0)))
            (add
                (mul (load.param $p)
                     (mul (get (load.param $k) 0) (get (load.param $k) 1)))
                (mul (call $ecAdd (load.param $p) (load.param $q) (load.param $m))
                     (mul (get (load.param $k) 0)
                          (sub (scalar 1) (get (load.param $k) 1)))))))

    (function $schnorrInit
        (result vector 14)
        (param $g vector 2) (param $p vector 2) (param $r vector 2)
        (vector
            (load.param $g)
            (scalar 0) (scalar 0)
            (call $dblSlope (load.param $g))
            (scalar 0) (scalar 1)
            (load.param $p)
            (load.param $r)
            (call $dblSlope (load.param $p))
            (div (sub (get (load.param $p) 1) (get (load.param $r) 1))
                 (sub (get (load.param $p) 0) (get (load.param $r) 0)))
            (scalar 0)))"""


def _lib224_schnorr_export() -> str:
    return """    (export VerifySchnorrSignature
        (registers 14) (constraints 18) (steps 256)
        (static
            (input secret (shift -1))
            (input secret (peerof 0) (shift -1))
            (input secret (childof 0) (steps 1))
            (input secret (peerof 0) (shift -1))
            (input secret (peerof 0) (shift -1))
            (input secret (childof 0) (steps 1))
            (input secret (peerof 0) (shift -1))
            (input secret (peerof 0) (shift -1))
            (mask (input 0))
            (cycle (power 2 256)))
        (init
            (call $schnorrInit
                (slice (load.static 0) 0 1)
                (slice (load.static 0) 3 4)
                (slice (load.static 0) 6 7)))
        (transition
            (local $p1 vector 2) (local $q1 vector 2) (local $mp1 scalar) (local $mq1 scalar) (local $skip1 scalar)
            (local $p2 vector 2) (local $q2 vector 2) (local $mp2 scalar) (local $mq2 scalar)
            (store.local $p1
                (call $ecAdd (slice (load.trace 0) 0 1) (slice (load.trace 0) 0 1)
                             (get (load.trace 0) 4)))
            (store.local $p2
                (call $ecAdd (slice (load.trace 0) 7 8) (slice (load.trace 0) 7 8)
                             (get (load.trace 0) 11)))
            (store.local $q1
                (call $accStep (slice (load.trace 0) 0 1) (slice (load.trace 0) 2 3)
                               (get (load.trace 0) 5)
                               (vector (get (load.static 0) 2) (get (load.trace 0) 6))))
            (store.local $q2
                (call $accStep (slice (load.trace 0) 7 8) (slice (load.trace 0) 9 10)
                               (get (load.trace 0) 12)
                               (vector (get (load.static 0) 5) (scalar 0))))
            (store.local $skip1
                (mul (sub (scalar 1) (get (load.static 0) 2))
                     (get (load.trace 0) 6)))
            (store.local $mp1 (call $dblSlope (load.local $p1)))
            (store.local $mp2 (call $dblSlope (load.local $p2)))
            (store.local $mq1
                (mul (div (sub (get (load.local $p1) 1) (get (load.local $q1) 1))
                          (sub (get (load.local $p1) 0) (get (load.local $q1) 0)))
                     (sub (scalar 1) (load.local $skip1))))
            (store.local $mq2
                (div (sub (get (load.local $p2) 1) (get (load.local $q2) 1))
                     (sub (get (load.local $p2) 0) (get (load.local $q2) 0))))
            (add
                (mul (call $schnorrInit
                         (slice (load.static 0) 0 1)
                         (slice (load.static 0) 3 4)
                         (slice (load.static 0) 6 7))
                     (get (load.static 0) 8))
                (mul (vector
                         (load.local $p1) (load.local $q1) (load.local $mp1) (load.local $mq1) (load.local $skip1)
                         (load.local $p2) (load.local $q2) (load.local $mp2) (load.local $mq2)
                         (add (get (load.trace 0) 13)
                              (mul (get (load.static 0) 5) (get (load.static 0) 9))))
                     (sub (scalar 1) (get (load.static 0) 8)))))
        (evaluation
            (local $p1 vector 2) (local $q1 vector 2) (local $cp1 scalar) (local $cq1 scalar) (local $skip1 scalar)
            (local $p2 vector 2) (local $q2 vector 2) (local $cp2 scalar) (local $cq2 scalar)
            (store.local $p1
                (call $ecAdd (slice (load.trace 0) 0 1) (slice (load.trace 0) 0 1)
                             (get (load.trace 0) 4)))
            (store.local $p2
                (call $ecAdd (slice (load.trace 0) 7 8) (slice (load.trace 0) 7 8)
                             (get (load.trace 0) 11)))
            (store.local $q1
                (call $accStep (slice (load.trace 0) 0 1) (slice (load.trace 0) 2 3)
                               (get (load.trace 0) 5)
                               (vector (get (load.static 0) 2) (get (load.trace 0) 6))))
            (store.local $q2
                (call $accStep (slice (load.trace 0) 7 8) (slice (load.trace 0) 9 10)
                               (get (load.trace 0) 12)
                               (vector (get (load.static 0) 5) (scalar 0))))
            (store.local $skip1
                (mul (sub (scalar 1) (get (load.static 0) 2))
                     (get (load.trace 0) 6)))
            (store.local $cp1
                (sub (add (mul (scalar 3) (exp (get (load.trace 0) 0) (scalar 2)))
                          (load.const $a))
                     (mul (mul (scalar 2) (get (load.trace 0) 1))
                          (get (load.trace 0) 4))))
            (store.local $cp2
                (sub (add (mul (scalar 3) (exp (get (load.trace 0) 7) (scalar 2)))
                          (load.const $a))
                     (mul (mul (scalar 2) (get (load.trace 0) 8))
                          (get (load.trace 0) 11))))
            (store.local $cq1
                (mul (sub (sub (get (load.trace 0) 1) (get (load.trace 0) 3))
                          (mul (sub (get (load.trace 0) 0) (get (load.trace 0) 2))
                               (get (load.trace 0) 5)))
                     (sub (scalar 1) (get (load.trace 0) 6))))
            (store.local $cq2
                (sub (sub (get (load.trace 0) 8) (get (load.trace 0) 10))
                     (mul (sub (get (load.trace 0) 7) (get (load.trace 0) 9))
                          (get (load.trace 0) 12))))
            (sub
                (vector
                    (slice (load.trace 1) 0 3) (scalar 0) (scalar 0) (get (load.trace 1) 6)
                    (slice (load.trace 1) 7 10) (scalar 0) (scalar 0) (get (load.trace 1) 13)
                    (sub (exp (get (load.static 0) 2) (scalar 2)) (get (load.static 0) 2))
                    (sub (exp (get (load.static 0) 5) (scalar 2)) (get (load.static 0) 5))
                    (scalar 0) (scalar 0))
                (add
                    (mul (vector
                             (slice (load.static 0) 0 1) (scalar 0) (scalar 0) (load.local $cp1) (load.local $cq1) (scalar 1)
                             (slice (load.static 0) 3 4) (slice (load.static 0) 6 7) (load.local $cp2) (load.local $cq2) (scalar 0)
                             (scalar 0) (scalar 0)
                             (sub (slice (load.trace 0) 2 3) (slice (load.trace 0) 9 10)))
                         (get (load.static 0) 8))
                    (mul (vector
                             (load.local $p1) (load.local $q1) (load.local $cp1) (load.local $cq1) (load.local $skip1)
                             (load.local $p2) (load.local $q2) (load.local $cp2) (load.local $cq2)
                             (add (get (load.trace 0) 13)
                                  (mul (get (load.static 0) 5) (get (load.static 0) 9)))
                             (scalar 0) (scalar 0) (scalar 0) (scalar 0))
                         (sub (scalar 1) (get (load.static 0) 8)))))))"""


def _lib224_exports() -> str:
    kc = _key_cycles(3)
    sc = _schedule_cycle()
    return f"""    (export ComputePoseidonHash
        (registers 3) (constraints 3) (steps {STEPS})
        (static
            (input secret (steps {STEPS}) (shift -1))
            (input secret (steps {STEPS}) (shift -1))
            (mask (input 0))
{sc}
{kc})
        (init
            (vector (slice (load.static 0) 0 1) (scalar 0)))
        (transition
            (local vector 3)
            (store.local 0
                (call $round (load.trace 0) (slice (load.static 0) 4 6)
                             (get (load.static 0) 3)))
            (add
                (mul (vector (slice (load.static 0) 0 1) (scalar 0))
                     (get (load.static 0) 2))
                (mul (load.local 0) (sub (scalar 1) (get (load.static 0) 2)))))
        (evaluation
            (local vector 3)
            (store.local 0
                (call $round (load.trace 0) (slice (load.static 0) 4 6)
                             (get (load.static 0) 3)))
            (sub (load.trace 1)
                 (add
                     (mul (vector (slice (load.static 0) 0 1) (scalar 0))
                          (get (load.static 0) 2))
                     (mul (load.local 0)
                          (sub (scalar 1) (get (load.static 0) 2)))))))

    (export ComputeMerkleRoot
        (registers 6) (constraints 6) (steps {STEPS})
        (static
            (input secret (shift -1))
            (input secret (childof 0) (steps {STEPS}) (shift -1))
            (input public (childof 0) (steps {STEPS}) (shift -1))
            (mask (input 0))
            (mask (input 1))
{sc}
{kc})
        (init
            (call $hashInit (get (load.static 0) 0) (get (load.static 0) 1)))
        (transition
            (call $merkleStep (load.trace 0) (load.static 0)))
        (evaluation
            (sub (load.trace 1)
                 (call $merkleStep (load.trace 0) (load.static 0)))))

    (export ComputeMerkleUpdate
        (registers 12) (constraints 13) (steps {STEPS})
        (static
            (input secret (shift -1))
            (input secret (peerof 0) (shift -1))
            (input secret (childof 0) (steps {STEPS}) (shift -1))
            (input secret (childof 0) (steps {STEPS}) (shift -1))
            (mask (input 0))
            (mask (input 2))
{sc}
{kc})
        (init
            (vector
                (call $hashInit (get (load.static 0) 0) (get (load.static 0) 2))
                (call $hashInit (get (load.static 0) 1) (get (load.static 0) 2))))
        (transition
            (vector
                (call $merkleStep (slice (load.trace 0) 0 5)
                      (vector (get (load.static 0) 0) (slice (load.static 0) 2 9)))
                (call $merkleStep (slice (load.trace 0) 6 11)
                      (vector (get (load.static 0) 1) (slice (load.static 0) 2 9)))))
        (evaluation
            (local $t vector 12)
            (store.local $t
                (vector
                    (call $merkleStep (slice (load.trace 0) 0 5)
                          (vector (get (load.static 0) 0) (slice (load.static 0) 2 9)))
                    (call $merkleStep (slice (load.trace 0) 6 11)
                          (vector (get (load.static 0) 1) (slice (load.static 0) 2 9)))))
            (vector
                (sub (load.trace 1) (load.local $t))
                (sub (exp (get (load.static 0) 3) (scalar 2))
                     (get (load.static 0) 3)))))"""


def _pointmul_export() -> str:
    # single-lane double-and-add: registers [P(2), Q(2), mDbl, mAdd,
    # qIsNull, bitAcc]; the evaluation checks the in-trace slopes instead of
    # recomputing the divisions (keeps constraints polynomial)
    return """    (export default
        (registers 8) (constraints 8) (steps 1)
        (static
            (input secret (shift -1))
            (input secret (peerof 0) (shift -1))
            (input secret (childof 0) (steps 1))
            (mask (input 0))
            (cycle (power 2 256)))
        (init
            (call $mulInit (slice (load.static 0) 0 1)))
        (transition
            (local $p vector 2) (local $q vector 2) (local $md scalar) (local $ma scalar) (local $skip scalar)
            (store.local $p
                (call $ecAdd (slice (load.trace 0) 0 1) (slice (load.trace 0) 0 1)
                             (get (load.trace 0) 4)))
            (store.local $q
                (call $accStep (slice (load.trace 0) 0 1) (slice (load.trace 0) 2 3)
                               (get (load.trace 0) 5)
                               (vector (get (load.static 0) 2) (get (load.trace 0) 6))))
            (store.local $skip
                (mul (sub (scalar 1) (get (load.static 0) 2))
                     (get (load.trace 0) 6)))
            (store.local $md (call $dblSlope (load.local $p)))
            (store.local $ma
                (mul (div (sub (get (load.local $p) 1) (get (load.local $q) 1))
                          (sub (get (load.local $p) 0) (get (load.local $q) 0)))
                     (sub (scalar 1) (load.local $skip))))
            (add
                (mul (call $mulInit (slice (load.static 0) 0 1))
                     (get (load.static 0) 3))
                (mul (vector
                         (load.local $p) (load.local $q) (load.local $md) (load.local $ma) (load.local $skip)
                         (add (get (load.trace 0) 7)
                              (mul (get (load.static 0) 2) (get (load.static 0) 4))))
                     (sub (scalar 1) (get (load.static 0) 3)))))
        (evaluation
            (local $p vector 2) (local $q vector 2) (local $cd scalar) (local $ca scalar) (local $skip scalar)
            (store.local $p
                (call $ecAdd (slice (load.trace 0) 0 1) (slice (load.trace 0) 0 1)
                             (get (load.trace 0) 4)))
            (store.local $q
                (call $accStep (slice (load.trace 0) 0 1) (slice (load.trace 0) 2 3)
                               (get (load.trace 0) 5)
                               (vector (get (load.static 0) 2) (get (load.trace 0) 6))))
            (store.local $skip
                (mul (sub (scalar 1) (get (load.static 0) 2))
                     (get (load.trace 0) 6)))
            (store.local $cd
                (sub (add (mul (scalar 3) (exp (get (load.trace 0) 0) (scalar 2)))
                          (load.const $a))
                     (mul (mul (scalar 2) (get (load.trace 0) 1))
                          (get (load.trace 0) 4))))
            (store.local $ca
                (mul (sub (sub (get (load.trace 0) 1) (get (load.trace 0) 3))
                          (mul (sub (get (load.trace 0) 0) (get (load.trace 0) 2))
                               (get (load.trace 0) 5)))
                     (sub (scalar 1) (get (load.trace 0) 6))))
            (sub
                (vector
                    (slice (load.trace 1) 0 3) (scalar 0) (scalar 0) (slice (load.trace 1) 6 7))
                (add
                    (mul (vector
                             (slice (load.static 0) 0 1) (scalar 0) (scalar 0) (load.local $cd) (load.local $ca) (scalar 1) (scalar 0))
                         (get (load.static 0) 3))
                    (mul (vector
                             (load.local $p) (load.local $q) (load.local $cd) (load.local $ca) (load.local $skip)
                             (add (get (load.trace 0) 7)
                                  (mul (get (load.static 0) 2) (get (load.static 0) 4))))
                         (sub (scalar 1) (get (load.static 0) 3)))))))"""


_MULINIT = """    (function $mulInit
        (result vector 8)
        (param $p vector 2)
        (vector
            (load.param $p)
            (scalar 0) (scalar 0)
            (call $dblSlope (load.param $p))
            (scalar 0) (scalar 1) (scalar 0)))"""


@lru_cache(maxsize=None)
def pointmul_source() -> str:
    """EC scalar multiplication over secp224r1 (behavioral spec:
    the reference's examples/elliptic/pointmul.aa): 8 regs x 256 steps,
    double-and-add with in-trace slope witnesses."""
    ec = _lib224_ec_fns()
    # pointmul needs only the EC helpers, not the Schnorr initializer
    ec = ec[:ec.index("    (function $schnorrInit")].rstrip()
    return "\n\n".join([
        "(module",
        f"    (field prime {P224})",
        f"    (const $a scalar {P224 - 3})",
        ec,
        _MULINIT,
        _pointmul_export(),
        ")"])


@lru_cache(maxsize=None)
def lib224_source() -> str:
    """The 224-bit stdlib: 3-wide Poseidon hash / MerkleRoot / MerkleUpdate
    plus VerifySchnorrSignature (14 regs x 256 steps over secp224r1) over
    p = 2^224 - 2^96 + 1."""
    return "\n\n".join([
        "(module",
        f"    (field prime {P224})",
        f"    (const $a scalar {P224 - 3})",       # secp224r1: a = -3 mod p
        _mds_const(P224, 3),
        _poseidon_round(3),
        _lib224_merkle_fns(),
        _lib224_ec_fns(),
        _lib224_schnorr_export(),
        _lib224_exports(),
        ")"])
