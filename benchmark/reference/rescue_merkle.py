"""The Rescue Merkle-branch AIR of genSTARK's `rescue/merkleProof.ts`, built as
data (the form `air.py` evaluates) from the configuration's `rescue` section
by plain code.

Eight registers, two Rescue lanes of four: lane A hashes (H, node, 0, 0),
lane B (node, H, 0, 0), where H is the previous level's digest or, at the
first level, the leaf.  A level takes `steps_per_level` steps: the loaded
state, then a round a step, `S = mds # r^alpha + K1` forward and
`N = (inv_mds # (n - K2))^alpha` back from the next row, with K1 and K2 the
round's two key states (the grouped round constants).  The constraint of
register i, lane L, row j of its lane, is

    round * (N_j - S_j) + first * (next[i] - leaf_i) + (1 - first) * level * (next[i] - node_i)

with `round` the cyclic selector of the steps that run a round, `first` the
mask of the leaf's span (the whole trace) and `level` the mask of every
level's span; H picks lane B's first register where the level's index bit
is 1, else lane A's.

Static registers, in the order the port's AirScript compile gives them:
the leaf (secret, rank 1), the sibling and the index bit (a level each,
`steps_per_level` steps; the bit public and binary), the eight rows of
round constants (cyclic), the two masks, the round selector.

Where this departs from `merkleProof.ts`'s text, it follows the port's
AirScript compile of that text: `enforce S = N` is the
polynomial N - S; `h <- indexBit ? $r4 : $r0` is bit * r4 + (1 - bit) * r0;
the `for each` blocks are the masks and the selector above, each
constraint one sum of the three; and an input register's values start one
step early (shift -1), so each mask's one falls on the last step of its
span, whose next row is the span's first.  The inverse MDS matrix is the
configuration's, derived from `mds` (upstream inlines it).
"""

from __future__ import annotations

from typing import List

from .poseidon_merkle import _Dag

LEAF, NODE, BIT = range(3)
CONSTANTS = 3                       # registers 3 .. 10: the round constants by row
FIRST, LEVEL, ROUND = 11, 12, 13


def _registers(c: dict) -> List[dict]:
    steps = c["steps_per_level"]

    def inp(secret, rank, binary=False, parent=None, steps=None):
        return {"kind": "input", "secret": secret, "rank": rank, "binary": binary,
                "parent": parent, "peer": None, "steps": steps, "shift": -1}
    # a round runs from step t of a level to t + 1 for t + 1 in 1 .. steps - 1
    rounds = [1 if t + 1 < steps else 0 for t in range(steps)]
    return ([inp(True, 1), inp(True, 2, parent=LEAF, steps=steps),
             inp(False, 2, binary=True, parent=LEAF, steps=steps)]
            + [{"kind": "cyclic", "values": list(row)} for row in c["round_constants"]]
            + [{"kind": "mask", "source": LEAF, "inverted": False},
               {"kind": "mask", "source": NODE, "inverted": False},
               {"kind": "cyclic", "values": rounds}])


def schema(config: dict) -> dict:
    c = config["rescue"]
    m, alpha, mds, inv_mds = c["width"], c["alpha"], c["mds"], c["inv_mds"]
    if len(c["round_constants"]) != 2 * m or \
            any(len(row) != c["steps_per_level"] for row in c["round_constants"]):
        raise ValueError("two rows of round constants a register, a value a step of the level")
    g = _Dag()
    constraints = []
    for i in range(2 * m):
        lane, row = divmod(i, m)
        base = lane * m
        back = g.add("exp", g.total([
            g.add("mul", g.add("const", inv_mds[row][k]),
                  g.add("sub", g.add("next", base + k), g.add("static", CONSTANTS + m + k)))
            for k in range(m)]), alpha)
        forward = g.add("add", g.total([
            g.add("mul", g.add("const", mds[row][k]), g.add("exp", g.add("trace", base + k), alpha))
            for k in range(m)]), g.add("static", CONSTANTS + row))
        body = g.add("mul", g.add("static", ROUND), g.add("sub", back, forward))

        def digest():                 # H: lane B's first register if the bit is 1, else lane A's
            return g.add("add", g.add("mul", g.add("static", BIT), g.add("trace", m)),
                         g.add("mul", g.add("sub", g.add("const", 1), g.add("static", BIT)),
                               g.add("trace", 0)))
        if row < 2:                   # the loaded state: (H, node) in lane A, (node, H) in B
            hashed = (row == 0) == (lane == 0)
            leaf_term = g.add("static", LEAF if hashed else NODE)
            node_term = digest() if hashed else g.add("static", NODE)
        else:
            leaf_term = node_term = g.add("const", 0)
        body = g.add("add", body, g.add("mul", g.add("static", FIRST),
                                        g.add("sub", g.add("next", i), leaf_term)))
        level = g.add("mul", g.add("sub", g.add("const", 1), g.add("static", FIRST)),
                      g.add("static", LEVEL))
        body = g.add("add", body, g.add("mul", level, g.add("sub", g.add("next", i), node_term)))
        constraints.append(body)
    return {"trace_width": 2 * m, "static_registers": _registers(c), "nodes": g.nodes,
            "constraints": constraints, "base_steps": c["steps_per_level"]}
