"""Rescue STARKs (AirScript) on the PyTorch port, the three configs of
examples/rescue.py with the same source text, options and control-value
oracle (examples/rescue_utils.py), importing only genstark_tpu_torch:

- hash2x64: 2 registers x 32 steps over p = 2^64 - 21*2^30 + 1, a
  hash-preimage proof;
- hash4x128: 4 registers x 32 steps over p = 2^128 - 9*2^32 + 1;
- merkle_proof: 8 registers x (32 * depth) steps, Merkle-branch
  verification with nested inputs and a public indexBit register (the
  reference's published benchmark row: depth 16, 2^9 steps).

    python -m examples.rescue_torch [depth] [device]

proves and verifies hash2x64 and the Merkle proof at `depth` (default 4)
on `device` (default cuda).
"""

from __future__ import annotations

from typing import List, Optional

from genstark_tpu_torch import instantiate_script
from genstark_tpu_torch.field import P64, P128, create_prime_field
from genstark_tpu_torch.protocol import Assertion
from genstark_tpu_torch.utils import inline_matrix, inline_vector

from .rescue_utils import MerkleTree, Rescue, invert_matrix, make_hash_function

# --- parameters (hash2x64.ts:10-33) -----------------------------------------

P64_ALPHA = 3
P64_INV_ALPHA = -6148914683720324437
P64_MDS = [[18446744051160973310, 18446744051160973301], [4, 13]]
P64_CONSTANTS = [
    1908230773479027697, 11775995824954138427, 18345613653544031596,
    8765075832563166921, 10398013025088720944, 5494050611496560306,
    17002767073604012844, 4907993559994152336,
]

# --- parameters (hash4x128.ts:8-33 / merkleProof.ts:8-37) --------------------

P128_ALPHA = 3
P128_INV_ALPHA = -113427455640312821154458202464371168597
P128_MDS = [
    [340282366920938463463374607393113505064, 340282366920938463463374607393113476633,
     340282366920938463463374607393112623703, 340282366920938463463374607393088807273],
    [1080, 42471, 1277640, 35708310],
    [340282366920938463463374607393113505403, 340282366920938463463374607393113491273,
     340282366920938463463374607393113076364, 340282366920938463463374607393101570233],
    [40, 1210, 33880, 925771],
]
P128_CONSTANTS = [
    144517900019036866096022507193071809599, 271707809579969091656092579345468860225,
    139424957805302989189422527487860690608, 126750251129487986697737866024960215983,
    271118613762407276564214152179206069413, 39384648060424157691646880565718875760,
    189037434251220539428539337560615209464, 218986062987136192416421725751708413726,
    103808983578136303126641899945581033860, 198823153506012419365570940451368319246,
    339599443104046223725845265111864465825, 169004341575174204803282453992954960786,
    171596418631454858790177474513731208863, 157569361262795131998922854453557743690,
    211837534394685913032370295607135890739, 328609939009439440841980058678511564944,
    229628671790616575443886906286361261591, 95675137928612392156876334331168593412,
    301613873771889848137714364785485714735, 278224571298089265666737094541710980794,
    140049647417493050970983064725330334359, 159594320057012289760186736637936788141,
    44954493393746175043012738454844468290, 223519669575552375517628855932195463175,
]

STEPS = 32
DEFAULT_OPTIONS = {                 # hash2x64.ts:37-43
    "hash_algorithm": "blake2s256",
    "extension_factor": 16,
    "exe_query_count": 68,
    "fri_query_count": 24,
}
MERKLE_OPTIONS = {                  # merkleProof.ts:43-49
    "hash_algorithm": "blake2s256",
    "extension_factor": 16,
    "exe_query_count": 60,
    "fri_query_count": 24,
}


def make_rescue(width: int):
    """Rescue instance + grouped constants for trace width `width` (2 or 4)."""
    if width == 2:
        field, mds, constants = create_prime_field(P64), P64_MDS, P64_CONSTANTS
        alpha, inv_alpha = P64_ALPHA, P64_INV_ALPHA
    else:
        field, mds, constants = create_prime_field(P128), P128_MDS, P128_CONSTANTS
        alpha, inv_alpha = P128_ALPHA, P128_INV_ALPHA
    rescue = Rescue(field.host, alpha, inv_alpha, width, STEPS, mds, constants)
    key_states = rescue.unroll_constants()
    initial_constants, round_constants = rescue.group_constants(key_states)
    return field, rescue, key_states, initial_constants, round_constants


def build_inputs(field, rescue, mds, initial_constants, values: List[int]):
    """Pre-compute the first half-round on the host so the trace starts one
    step in (hash2x64.ts:118-135 buildInputs)."""
    m = rescue.registers
    f = field.host
    r = [f.add(values[i] if i < len(values) else 0, initial_constants[i])
         for i in range(m)]
    a = [rescue._exp(v, rescue.inv_alpha) for v in r]
    return [f.add(sum(f.mul(mds[i][j], a[j]) for j in range(m)) % f.p,
                  initial_constants[m + i])
            for i in range(m)]


def hash_source(width: int, modulus_expr: str, alpha: int, inv_alpha_pos: int,
                mds, inv_mds, round_constants) -> str:
    regs = ", ".join(f"value{i+1}" for i in range(width))
    rc_cycles = ",\n        ".join(
        f"cycle {inline_vector(c)}" for c in round_constants)
    return f"""
define Rescue{width}x{64 if width == 2 else 128} over prime field ({modulus_expr}) {{
    const alpha: {alpha};
    const inv_alpha: {inv_alpha_pos};
    const mds: {inline_matrix(mds)};
    const inv_mds: {inline_matrix(inv_mds)};

    static roundConstants: [
        {rc_cycles}
    ];

    {chr(10).join(f'    secret input value{i+1}: element[1];' for i in range(width)).strip()}

    transition {width} registers {{
        for each ({regs}) {{
            init {{ yield [{regs}]; }}
            for steps [1..31] {{
                S <- mds # $r^alpha + roundConstants[0..{width-1}];
                yield mds # (/S)^(inv_alpha) + roundConstants[{width}..{2*width-1}];
            }}
        }}
    }}

    enforce {width} constraints {{
        for each ({regs}) {{
            init {{ enforce [{regs}] = $n; }}
            for steps [1..31] {{
                S <- mds # $r^alpha + roundConstants[0..{width-1}];
                N <- (inv_mds # ($n - roundConstants[{width}..{2*width-1}]))^alpha;
                enforce S = N;
            }}
        }}
    }}
}}"""


def make_hash_stark(width: int = 2, options: Optional[dict] = None, device="cuda"):
    field, rescue, key_states, ic, rc = make_rescue(width)
    mds = rescue.mds
    inv_mds = invert_matrix(field.host, mds)
    modulus_expr = "2^64 - 21 * 2^30 + 1" if width == 2 else "2^128 - 9 * 2^32 + 1"
    src = hash_source(width, modulus_expr, rescue.alpha, -rescue.inv_alpha, mds, inv_mds, rc)
    stark = instantiate_script(src, options or dict(DEFAULT_OPTIONS), device=device)
    return stark, field, rescue, key_states, ic


def hash_case(width: int = 2, value: int = 42, options: Optional[dict] = None,
              device="cuda"):
    """(stark, assertions, inputs) of a hash-preimage proof."""
    stark, field, rescue, key_states, ic = make_hash_stark(width, options, device)
    values = [value] + [0] * (width - 1)
    inputs = build_inputs(field, rescue, rescue.mds, ic, values)
    expected, _ = rescue.modified_sponge(inputs, key_states)
    assertions = [Assertion(step=STEPS - 1, register=0, value=expected[0])]
    return stark, assertions, [[v] for v in inputs]


def run_hash(width: int = 2, value: int = 42, options: Optional[dict] = None,
             device="cuda"):
    """Prove knowledge of a hash preimage; returns (stark, proof, assertions)."""
    stark, assertions, inputs = hash_case(width, value, options, device)
    return stark, stark.prove(assertions, inputs), assertions


def merkle_source(alpha: int, inv_alpha_pos: int, mds, inv_mds,
                  round_constants) -> str:
    """AirScript text of the reference's examples/rescue/merkleProof.ts:51-146."""
    rc_cycles = ",\n        ".join(
        f"cycle {inline_vector(c)}" for c in round_constants)
    return f"""
define RescueMP over prime field (2^128 - 9 * 2^32 + 1) {{
    const alpha: {alpha};
    const inv_alpha: {inv_alpha_pos};
    const mds: {inline_matrix(mds)};
    const inv_mds: {inline_matrix(inv_mds)};

    static roundConstants: [
        {rc_cycles}
    ];

    secret input leaf       : element[1];
    secret input node       : element[1][1];
    public input indexBit   : boolean[1][1];

    transition 8 registers {{
        for each (leaf, node, indexBit) {{
            init {{
                yield [leaf, node, 0, 0, node, leaf, 0, 0];
            }}
            for each (node, indexBit) {{
                init {{
                    h <- indexBit ? $r4 : $r0;
                    yield [h, node, 0, 0, node, h, 0, 0];
                }}
                for steps [1..31] {{
                    S1 <- mds # $r[0..3]^alpha + roundConstants[0..3];
                    S1 <- mds # (/S1)^(inv_alpha) + roundConstants[4..7];
                    S2 <- mds # $r[4..7]^alpha + roundConstants[0..3];
                    S2 <- mds # (/S2)^(inv_alpha) + roundConstants[4..7];
                    yield [...S1, ...S2];
                }}
            }}
        }}
    }}

    enforce 8 constraints {{
        for each (leaf, node, indexBit) {{
            init {{
                enforce [leaf, node, 0, 0, node, leaf, 0, 0] = $n;
            }}
            for each (node, indexBit) {{
                init {{
                    h <- indexBit ? $r4 : $r0;
                    enforce [h, node, 0, 0, node, h, 0, 0] = $n;
                }}
                for steps [1..31] {{
                    S1 <- mds # $r[0..3]^alpha + roundConstants[0..3];
                    N1 <- (inv_mds # ($n[0..3] - roundConstants[4..7]))^alpha;
                    S2 <- mds # $r[4..7]^alpha + roundConstants[0..3];
                    N2 <- (inv_mds # ($n[4..7] - roundConstants[4..7]))^alpha;
                    enforce [...S1, ...S2] = [...N1, ...N2];
                }}
            }}
        }}
    }}
}}"""


def make_merkle_stark(options: Optional[dict] = None, device="cuda"):
    field, rescue, key_states, ic, rc = make_rescue(4)
    inv_mds = invert_matrix(field.host, rescue.mds)
    src = merkle_source(rescue.alpha, -rescue.inv_alpha, rescue.mds, inv_mds, rc)
    stark = instantiate_script(src, options or dict(MERKLE_OPTIONS), device=device)
    return stark, field, make_hash_function(rescue, key_states)


def to_binary_array(value: int, length: int) -> List[int]:
    return [(value >> i) & 1 for i in range(length)]


def merkle_case(tree_depth: int = 8, index: int = 42, options: Optional[dict] = None,
                device="cuda"):
    """(stark, assertions, inputs, public inputs) of a membership proof of
    `index` in a random tree (merkleProof.ts:148-188)."""
    stark, field, hash_fn = make_merkle_stark(options, device)
    leaves = field.prng(b"\x2a", 2 ** tree_depth)
    tree = MerkleTree(leaves, hash_fn)
    branch = tree.prove(index)
    assert MerkleTree.verify(tree.root, index, branch, hash_fn)
    # align index bits with the end of each hash cycle (merkleProof.ts:158-162)
    index_bits = [0] + to_binary_array(index, tree_depth)[:-1]
    inputs = [[branch[0]], [branch[1:]], [index_bits]]
    assertions = [Assertion(step=STEPS * tree_depth - 1, register=0, value=tree.root)]
    return stark, assertions, inputs, [[index_bits]]


def branch_case(tree_depth: int = 16, index: int = 42, options: Optional[dict] = None,
                device="cuda"):
    """merkle_case's statement without the tree behind it: the leaf and the
    `tree_depth` sibling values are drawn from the field prng and the root
    is folded from them by the oracle, `tree_depth` hashes instead of the
    2^tree_depth - 1 of a whole tree (the trace, proof size and prover work
    are those of merkle_case)."""
    stark, field, hash_fn = make_merkle_stark(options, device)
    branch = field.prng(b"\x2a", tree_depth + 1)
    root, position = branch[0], index
    for node in branch[1:]:
        root = hash_fn(node, root) if position & 1 else hash_fn(root, node)
        position >>= 1
    assert MerkleTree.verify(root, index, branch, hash_fn)
    index_bits = [0] + to_binary_array(index, tree_depth)[:-1]
    inputs = [[branch[0]], [branch[1:]], [index_bits]]
    assertions = [Assertion(step=STEPS * tree_depth - 1, register=0, value=root)]
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
    stark, proof, assertions = run_hash(2, device=dev)
    assert stark.verify(assertions, stark.parse(stark.serialize(proof)))
    print(f"rescue hash2x64: proof {stark.size_of(proof)} bytes, "
          f"security {stark.security_level}")
    stark, proof, assertions, public = run_merkle_proof(depth, 5, device=dev)
    assert stark.verify(assertions, stark.parse(stark.serialize(proof)), public)
    print(f"rescue merkle depth {depth}: proof {stark.size_of(proof)} bytes, "
          f"security {stark.security_level}")
