"""Poseidon STARKs (AirScript) on the PyTorch port, the configs of
examples/poseidon.py with the same source text, options and control-value
oracle (examples/poseidon_utils.py), importing only genstark_tpu_torch:

- hash3x128: 3 registers x 64 steps, S-box x^5, 8 full + 55 partial
  rounds, segment loops (hash6x128 with width 6);
- merkle_proof: 12 registers x (64 * depth) steps, dual Poseidon lanes
  over a Merkle branch with 2-element node values (the reference's
  published benchmark row: depth 16, 2^10 steps).

    python -m examples.poseidon_torch [depth] [device]

proves and verifies hash3x128 and the Merkle proof at `depth` (default 4)
on `device` (default cuda).
"""

from __future__ import annotations

from typing import List, Optional

from genstark_tpu_torch import instantiate_script
from genstark_tpu_torch.field import P128, create_prime_field
from genstark_tpu_torch.protocol import Assertion
from genstark_tpu_torch.utils import inline_matrix, inline_vector

from .poseidon_utils import (MerkleTree, create_hash, get_mds_matrix,
                             get_round_constants, to_binary_array, transpose)

F_ROUNDS, P_ROUNDS, SBOX = 8, 55, 5
STEPS = F_ROUNDS + P_ROUNDS + 1          # 64

HASH_OPTIONS = {                          # hash3x128.ts:35-41
    "hash_algorithm": "blake2s256",
    "extension_factor": 16,
    "exe_query_count": 68,
    "fri_query_count": 24,
}
MERKLE_OPTIONS = {                        # merkleProof.ts:25-31
    "hash_algorithm": "blake2s256",
    "extension_factor": 32,
    "exe_query_count": 44,
    "fri_query_count": 20,
}


def poseidon_params(width: int):
    field = create_prime_field(P128)
    mds = get_mds_matrix(field.host, width)
    # per-register round-constant cycles (transpose of ark rows), padded to 64
    rc = transpose(get_round_constants(field.host, width, STEPS))
    return field, mds, rc


def hash_source(width: int, mds, rc) -> str:
    rc_cycles = ",\n        ".join(f"cycle {inline_vector(c)}" for c in rc)
    if width == 3:
        inputs = "secret input value1: element[1];\n    secret input value2: element[1];"
        names = "value1, value2"
        init = "yield [value1, value2, 0];"
        partial = """v2 <- ($r2 + roundConstants[2])^5;
                yield mds # [...($r[0..1] + roundConstants[0..1]), v2];"""
    else:
        inputs = "secret input value1: element[2];\n    secret input value2: element[2];"
        names = "value1, value2"
        init = "yield [...value1, ...value2, 0, 0];"
        partial = """v5 <- ($r5 + roundConstants[5])^5;
                yield mds # [...($r[0..4] + roundConstants[0..4]), v5];"""
    return f"""
define Poseidon{width}x128 over prime field (2^128 - 9 * 2^32 + 1) {{
    const mds: {inline_matrix(mds)};

    static roundConstants: [
        {rc_cycles}
    ];

    {inputs}

    transition {width} registers {{
        for each ({names}) {{
            init {{ {init} }}
            for steps [1..4, 60..63] {{
                yield mds # ($r + roundConstants)^5;
            }}
            for steps [5..59] {{
                {partial}
            }}
        }}
    }}

    enforce {width} constraints {{
        for all steps {{
            enforce transition($r) = $n;
        }}
    }}
}}"""


def make_hash_stark(width: int = 3, options: Optional[dict] = None, device="cuda"):
    field, mds, rc = poseidon_params(width)
    stark = instantiate_script(hash_source(width, mds, rc),
                               options or dict(HASH_OPTIONS), device)
    return stark, field, create_hash(field.host, SBOX, F_ROUNDS, P_ROUNDS, width)


def hash_case(width: int = 3, options: Optional[dict] = None, device="cuda"):
    """(stark, assertions, inputs) of a hash proof."""
    stark, field, oracle = make_hash_stark(width, options, device)
    values = [42, 43] if width == 3 else [1, 2, 3, 4]
    result = oracle(values)
    assertions = [Assertion(step=STEPS - 1, register=0, value=result[0]),
                  Assertion(step=STEPS - 1, register=1, value=result[1])]
    return stark, assertions, [[v] for v in values]


def run_hash(width: int = 3, options: Optional[dict] = None, device="cuda"):
    stark, assertions, inputs = hash_case(width, options, device)
    return stark, stark.prove(assertions, inputs), assertions


def merkle_source(mds, rc) -> str:
    """AirScript text of the reference's examples/poseidon/merkleProof.ts:34-102."""
    rc_cycles = ",\n        ".join(f"cycle {inline_vector(c)}" for c in rc)
    return f"""
define PoseidonMP over prime field (2^128 - 9 * 2^32 + 1) {{
    const mds: {inline_matrix(mds)};
    const alpha: {SBOX};

    static roundConstants: [
        {rc_cycles}
    ];

    secret input leaf       : element[2];
    secret input node       : element[2][1];
    public input indexBit   : boolean[1][1];

    transition 12 registers {{
        for each (leaf, node, indexBit) {{
            init {{
                S1 <- [...leaf, ...node, 0, 0];
                S2 <- [...node, ...leaf, 0, 0];
                yield [...S1, ...S2];
            }}
            for each (node, indexBit) {{
                init {{
                    H <- indexBit ? $r[6..7] : $r[0..1];
                    S1 <- [...H, ...node, 0, 0];
                    S2 <- [...node, ...H, 0, 0];
                    yield [...S1, ...S2];
                }}
                for steps [1..4, 60..63] {{
                    S1 <- mds # ($r[0..5] + roundConstants)^alpha;
                    S2 <- mds # ($r[6..11] + roundConstants)^alpha;
                    yield  [...S1, ...S2];
                }}
                for steps [5..59] {{
                    v1 <- ($r5 + roundConstants[5])^5;
                    S1 <- mds # [...($r[0..4] + roundConstants[0..4]), v1];
                    v2 <- ($r11 + roundConstants[5])^5;
                    S2 <- mds # [...($r[6..10] + roundConstants[0..4]), v2];
                    yield [...S1, ...S2];
                }}
            }}
        }}
    }}

    enforce 12 constraints {{
        for all steps {{
            enforce transition($r) = $n;
        }}
    }}
}}"""


def make_merkle_stark(options: Optional[dict] = None, device="cuda"):
    field, mds, rc = poseidon_params(6)
    stark = instantiate_script(merkle_source(mds, rc),
                               options or dict(MERKLE_OPTIONS), device)
    return stark, field, create_hash(field.host, SBOX, F_ROUNDS, P_ROUNDS, 6)


def build_leaves(field, count: int) -> List[List[int]]:
    """2-element leaves from the field PRNG (merkleProof.ts:154-167)."""
    v1 = field.prng(b"\x2a", count)
    v2 = field.prng(b"\x2b", count)
    return [[v1[i], v2[i]] for i in range(count)]


def merkle_case(tree_depth: int = 8, index: int = 42, options: Optional[dict] = None,
                device="cuda"):
    """(stark, assertions, inputs, public inputs) of a membership proof."""
    stark, field, oracle = make_merkle_stark(options, device)
    tree = MerkleTree(build_leaves(field, 2 ** tree_depth), oracle)
    branch = tree.prove(index)
    assert MerkleTree.verify(tree.root, index, branch, oracle)
    index_bits = [0] + to_binary_array(index, tree_depth)[:-1]
    leaf = branch[0]
    nodes = transpose(branch[1:])
    inputs = [[leaf[0]], [leaf[1]], [nodes[0]], [nodes[1]], [index_bits]]
    T = STEPS * tree_depth
    assertions = [Assertion(step=T - 1, register=0, value=tree.root[0]),
                  Assertion(step=T - 1, register=1, value=tree.root[1])]
    return stark, assertions, inputs, [[index_bits]]


def branch_case(tree_depth: int = 16, index: int = 42, options: Optional[dict] = None,
                device="cuda"):
    """merkle_case's statement without the tree behind it: the leaf and the
    `tree_depth` sibling values are drawn as build_leaves draws leaves and
    the root is folded from them by the oracle, `tree_depth` hashes instead
    of the 2^tree_depth - 1 of a whole tree (the trace, proof size and
    prover work are those of merkle_case)."""
    stark, field, oracle = make_merkle_stark(options, device)
    branch = build_leaves(field, tree_depth + 1)
    root, position = branch[0], index
    for node in branch[1:]:
        root = oracle(node + root) if position & 1 else oracle(root + node)
        position >>= 1
    assert MerkleTree.verify(root, index, branch, oracle)
    index_bits = [0] + to_binary_array(index, tree_depth)[:-1]
    nodes = transpose(branch[1:])
    inputs = [[branch[0][0]], [branch[0][1]], [nodes[0]], [nodes[1]], [index_bits]]
    T = STEPS * tree_depth
    assertions = [Assertion(step=T - 1, register=0, value=root[0]),
                  Assertion(step=T - 1, register=1, value=root[1])]
    return stark, assertions, inputs, [[index_bits]]


def run_merkle_proof(tree_depth: int = 8, index: int = 42,
                     options: Optional[dict] = None, device="cuda"):
    """Returns (stark, proof, assertions, public inputs)."""
    stark, assertions, inputs, public = merkle_case(tree_depth, index, options, device)
    return stark, stark.prove(assertions, inputs), assertions, public


if __name__ == "__main__":
    import sys
    depth = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    dev = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    stark, proof, assertions = run_hash(3, device=dev)
    assert stark.verify(assertions, stark.parse(stark.serialize(proof)))
    print(f"poseidon hash3x128: proof {stark.size_of(proof)} bytes, "
          f"security {stark.security_level}")
    stark, proof, assertions, public = run_merkle_proof(depth, 5, device=dev)
    assert stark.verify(assertions, stark.parse(stark.serialize(proof)), public)
    print(f"poseidon merkle depth {depth}: proof {stark.size_of(proof)} bytes, "
          f"security {stark.security_level}")
