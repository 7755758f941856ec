"""The Poseidon Merkle-branch AIR of genSTARK's `merkleProof.ts`, built as
data (the form `air.py` evaluates) from the configuration's `poseidon`
section by plain code.

Twelve registers, two Poseidon lanes of six: lane A hashes (H, node), lane
B (node, H), where H is the previous level's digest or, at the first
level, the leaf.  A level takes `steps_per_level` steps: a step that loads
the level's state, then the full / partial / full rounds.  The constraint
of register i is

    next[i] - (full * F_i + partial * P_i + first * leaf_i + (1 - first) * level * node_i)

with F_i and P_i the round functions of its lane, `full` and `partial` the
cyclic selectors of the rounds, `first` the mask of the trace's first
level and `level` the mask of every level's start; H picks lane B's first
two registers where the level's index bit is 1.

Static registers, in order: the leaf's two elements (secret, one a leaf),
the sibling's two elements and the index bit (a level each, 64 steps; the
bit public and binary), the round constants of each of the six columns
(cyclic, `steps_per_level` values), the two masks, the two selectors.
"""

from __future__ import annotations

from typing import List

LEAF0, LEAF1, NODE0, NODE1, BIT = range(5)
CONSTANTS = 5                       # registers 5 .. 10: the round constants by column
FIRST, LEVEL, FULL, PARTIAL = 11, 12, 13, 14
PAIRS = ((LEAF0, LEAF1), (NODE0, NODE1))   # lane A loads (leaf or H, node), lane B the reverse


class _Dag:
    def __init__(self):
        self.nodes: List[list] = []

    def add(self, *node) -> int:
        self.nodes.append(list(node))
        return len(self.nodes) - 1

    def total(self, terms: List[int]) -> int:
        out = terms[0]
        for t in terms[1:]:
            out = self.add("add", out, t)
        return out


def _registers(c: dict) -> List[dict]:
    steps = c["steps_per_level"]
    half = c["full_rounds"] // 2

    def inp(secret, rank, binary=False, parent=None, peer=None, steps=None):
        return {"kind": "input", "secret": secret, "rank": rank, "binary": binary,
                "parent": parent, "peer": peer, "steps": steps, "shift": -1}
    rounds = half * 2 + c["partial_rounds"]
    full = [1 if r < half or half + c["partial_rounds"] <= r < rounds else 0
            for r in range(steps)]
    partial = [1 if half <= r < half + c["partial_rounds"] else 0 for r in range(steps)]
    return ([inp(True, 1), inp(True, 1, peer=LEAF0),
             inp(True, 2, parent=LEAF0, steps=steps), inp(True, 2, parent=LEAF0, steps=steps),
             inp(False, 2, binary=True, parent=LEAF0, steps=steps)]
            + [{"kind": "cyclic", "values": [row[j] for row in c["round_constants"]]}
               for j in range(c["width"])]
            + [{"kind": "mask", "source": LEAF0, "inverted": False},
               {"kind": "mask", "source": NODE0, "inverted": False},
               {"kind": "cyclic", "values": full}, {"kind": "cyclic", "values": partial}])


def schema(config: dict) -> dict:
    c = config["poseidon"]
    m, alpha, mds = c["width"], c["alpha"], c["mds"]
    if len(c["round_constants"]) != c["steps_per_level"]:
        raise ValueError("one row of round constants a step of the level")
    g = _Dag()
    constraints = []
    for i in range(2 * m):
        lane, row = divmod(i, m)
        base = lane * m

        def rounded(j, sbox):
            x = g.add("add", g.add("trace", base + j), g.add("static", CONSTANTS + j))
            return g.add("exp", x, alpha) if sbox else x
        full = g.total([g.add("mul", g.add("const", mds[row][j]), rounded(j, True))
                        for j in range(m)])
        partial = g.total([g.add("mul", g.add("const", mds[row][j]), rounded(j, j == m - 1))
                           for j in range(m)])

        def digest(k):                # H: lane B's register k if the bit is 1, else lane A's
            bit = g.add("static", BIT)
            return g.add("add", g.add("mul", bit, g.add("trace", m + k)),
                         g.add("mul", g.add("sub", g.add("const", 1), g.add("static", BIT)),
                               g.add("trace", k)))
        if row < 4:                   # the level's loaded state: two pairs, then zeros
            pair, k = divmod(row, 2)
            src = PAIRS[pair] if lane == 0 else PAIRS[1 - pair]
            leaf_term = g.add("static", src[k])
            node_term = digest(k) if src == PAIRS[0] else g.add("static", src[k])
        else:
            leaf_term = node_term = g.add("const", 0)
        body = g.add("add", g.add("add", g.add("mul", g.add("static", FULL), full),
                                  g.add("mul", g.add("static", PARTIAL), partial)),
                     g.add("mul", g.add("static", FIRST), leaf_term))
        level = g.add("mul", g.add("sub", g.add("const", 1), g.add("static", FIRST)),
                      g.add("static", LEVEL))
        body = g.add("add", body, g.add("mul", level, node_term))
        constraints.append(g.add("sub", g.add("next", i), body))
    return {"trace_width": 2 * m, "static_registers": _registers(c), "nodes": g.nodes,
            "constraints": constraints, "base_steps": c["steps_per_level"]}
