"""Poseidon Merkle-branch statements: a fresh leaf, `depth` siblings and an
index below 2^(depth - 1) per statement; the root is folded by this module's own Poseidon
(width 6, x^alpha S-box, full / partial / full rounds, the configuration's
MDS matrix and round constants) and asserted on registers 0 and 1 at the
last step.  The index bits are the public input."""

from __future__ import annotations

from typing import List

from . import Statement, draw


def trace_steps(config: dict, traffic: dict) -> int:
    return config["poseidon"]["steps_per_level"]


def permutation(config: dict):
    c = config["poseidon"]
    p = config["field"]["modulus"]
    m, alpha = c["width"], c["alpha"]
    mds, ark = c["mds"], c["round_constants"]
    full, partial = c["full_rounds"], c["partial_rounds"]

    def hash_(values: List[int]) -> List[int]:
        state = [v % p for v in values] + [0] * (m - len(values))
        for i in range(full + partial):
            state = [(s + a) % p for s, a in zip(state, ark[i])]
            if i < full // 2 or i >= full // 2 + partial:
                state = [pow(s, alpha, p) for s in state]
            else:
                state[-1] = pow(state[-1], alpha, p)
            state = [sum(r * s for r, s in zip(row, state)) % p for row in mds]
        return state[:2]
    return hash_


def make(config: dict, traffic: dict, seed: int, index: int) -> Statement:
    p = config["field"]["modulus"]
    depth = traffic["depth"]
    hash_ = permutation(config)
    leaf = [draw(seed, index, f"leaf.{j}", p) for j in range(2)]
    siblings = [[draw(seed, index, f"node.{d}.{j}", p) for j in range(2)] for d in range(depth)]
    # the AIR asserts the root on its first lane, which holds the branch's
    # root when the last level's node is on the right: index < 2^(depth-1)
    position = draw(seed, index, "index", 1 << (depth - 1))
    root, at = leaf, position
    for node in siblings:
        root = hash_(node + root) if at & 1 else hash_(root + node)
        at >>= 1
    bits = [0] + [(position >> i) & 1 for i in range(depth - 1)]
    steps = config["poseidon"]["steps_per_level"] * depth
    return Statement(
        assertions=[(steps - 1, 0, root[0]), (steps - 1, 1, root[1])],
        inputs=[[leaf[0]], [leaf[1]], [[s[0] for s in siblings]], [[s[1] for s in siblings]],
                [bits]],
        public=[[bits]],
        shapes=[[1], [1], [1, depth], [1, depth], [1, depth]])
