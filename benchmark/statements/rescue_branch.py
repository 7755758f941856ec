"""Rescue Merkle-branch statements: a fresh leaf, `depth` siblings and an
index below 2^(depth - 1) per statement; the root is folded by this
module's own Rescue (the configuration's width-4 state, x^alpha and
x^inv_alpha S-boxes, MDS matrix and unrolled key states) in the
`modifiedSponge` 2-to-1 form of genSTARK's rescue/utils.ts, and asserted on
register 0 at the last step.  The index bits are the public input."""

from __future__ import annotations

from typing import List

from . import Statement, draw


def trace_steps(config: dict, traffic: dict) -> int:
    return config["rescue"]["steps_per_level"]


def hash_function(config: dict):
    """h(a, b): the first element of modifiedSponge([a, b, 0, 0]): from the
    unrolled key state 2 on, `steps_per_level - 1` rounds of x^alpha then
    x^inv_alpha, each followed by the MDS matrix and the round's key state."""
    c = config["rescue"]
    p = config["field"]["modulus"]
    mds, keys = c["mds"], c["key_states"]
    # x^inv_alpha with inv_alpha < 0 is (1/x)^-inv_alpha = x^(p - 1 + inv_alpha), 0 at 0
    powers = (c["alpha"] % (p - 1), c["inv_alpha"] % (p - 1))
    rounds = c["steps_per_level"] - 1

    def layer(state: List[int], e: int, key: List[int]) -> List[int]:
        s = [pow(v, e, p) for v in state]
        return [(sum(m * v for m, v in zip(row, s)) + k) % p for row, k in zip(mds, key)]

    def h(a: int, b: int) -> int:
        state = [a % p, b % p] + [0] * (c["width"] - 2)
        for r in range(rounds):
            state = layer(state, powers[0], keys[2 + 2 * r])
            state = layer(state, powers[1], keys[3 + 2 * r])
        return state[0]
    return h


def make(config: dict, traffic: dict, seed: int, index: int) -> Statement:
    p = config["field"]["modulus"]
    depth = traffic["depth"]
    h = hash_function(config)
    leaf = draw(seed, index, "leaf", p)
    siblings = [draw(seed, index, f"node.{d}", p) for d in range(depth)]
    # the AIR asserts the root on register 0, lane A's hash(h, node): the
    # branch's root where the last level's node is on the right, index < 2^(depth-1)
    position = draw(seed, index, "index", 1 << (depth - 1))
    root, at = leaf, position
    for node in siblings:
        root = h(node, root) if at & 1 else h(root, node)
        at >>= 1
    bits = [0] + [(position >> i) & 1 for i in range(depth - 1)]
    steps = config["rescue"]["steps_per_level"] * depth
    return Statement(assertions=[(steps - 1, 0, root)],
                     inputs=[[leaf], [siblings], [bits]],
                     public=[[bits]],
                     shapes=[[1], [1, depth], [1, depth]])
