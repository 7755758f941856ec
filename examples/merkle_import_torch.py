"""AirScript programs that import AirAssembly components, on the PyTorch
port: the two programs of examples/merkle_import.py with the same source
text, options and oracle (examples/assembly_lib.py's `poseidon_oracle`,
copied here; the Merkle trees of examples/poseidon_utils.py), importing
only genstark_tpu_torch:

- merkle_proof: `import { ComputePoseidonHash as Hash }` and dual `with
  $r[..] yield Hash(...)` lanes over a Merkle branch (6 registers x
  64*depth steps, p224);
- merkle_update: whole-body re-export of ComputeMerkleUpdate under AirScript
  input declarations (12 registers, 13 constraints).

The `'../assembly/lib224.aa'` imports resolve to the port's generated
stdlib (genstark_tpu_torch/stdlib).

    python -m examples.merkle_import_torch [depth] [device]
"""

from __future__ import annotations

from typing import Optional

from genstark_tpu_torch import instantiate_script
from genstark_tpu_torch.field import P128, P224, create_prime_field
from genstark_tpu_torch.protocol import Assertion

from .poseidon_utils import MerkleTree2, create_hash, to_binary_array, transpose

F_ROUNDS, P_ROUNDS, SBOX = 8, 55, 5
STEPS = 64

OPTIONS = {                          # merkleProof.ts:30-36
    "hash_algorithm": "blake2s256",
    "extension_factor": 32,
    "exe_query_count": 44,
    "fri_query_count": 20,
}

MERKLE_PROOF_SRC = """
import { ComputePoseidonHash as Hash } from '../assembly/lib224.aa';

define MerkleBranch over prime field (2^224 - 2^96 + 1) {

    secret input leaf       : element[1];
    secret input node       : element[1][1];
    public input indexBit   : boolean[1][1];

    transition 6 registers {
        for each (leaf, node, indexBit) {
            init {
                s1 <- [leaf, node, 0];
                s2 <- [node, leaf, 0];
                yield [...s1, ...s2];
            }
            for each (node, indexBit) {
                h <- indexBit ? $r3 : $r0;
                with $r[0..2] yield Hash(h, node);
                with $r[3..5] yield Hash(node, h);
            }
        }
    }

    enforce 6 constraints {
        for all steps {
            enforce transition($r) = $n;
        }
    }
}"""

MERKLE_UPDATE_SRC = """
import { ComputeMerkleUpdate } from '../assembly/lib224.aa';

define MerkleBranch over prime field (2^224 - 2^96 + 1) {

    secret input oldLeaf    : element[1];
    secret input newLeaf    : element[1];
    secret input authPath   : element[1][1];
    secret input indexBits  : boolean[1][1];

    transition 12 registers {
        for each (oldLeaf, newLeaf, authPath, indexBits) {
            yield ComputeMerkleUpdate(oldLeaf, newLeaf, authPath, indexBits);
        }
    }

    enforce 13 constraints {
        for each (oldLeaf, newLeaf, authPath, indexBits) {
            enforce ComputeMerkleUpdate(oldLeaf, newLeaf, authPath, indexBits);
        }
    }
}"""



def poseidon_oracle(lib: str):
    """Poseidon with the prng-derived constants the .aa cycles declare
    (lib128.ts:20-28 / lib224.ts:20-25); examples/assembly_lib.py's."""
    if lib == "128":
        field, width = create_prime_field(P128), 6
    else:
        field, width = create_prime_field(P224), 3
    cols = [field.prng(f"Hades{j}".encode(), STEPS) for j in range(1, width + 1)]
    return field, create_hash(field.host, SBOX, F_ROUNDS, P_ROUNDS, width, transpose(cols))


def merkle_proof_case(tree_depth: int = 8, index: int = 42,
                      options: Optional[dict] = None, device="cuda"):
    """(stark, assertions, inputs, public inputs) of a membership proof of
    `index` in a random tree (merkleProof.ts:80-108)."""
    field, oracle = poseidon_oracle("224")
    stark = instantiate_script(MERKLE_PROOF_SRC, options or dict(OPTIONS), device)
    tree = MerkleTree2(field.prng(b"\x2a", 2 ** tree_depth), oracle)
    branch = tree.prove(index)
    bits = [0] + to_binary_array(index, tree_depth)[:-1]
    inputs = [[branch[0]], [branch[1:]], [bits]]
    assertions = [Assertion(step=STEPS * tree_depth - 1, register=0, value=tree.root)]
    return stark, assertions, inputs, [[bits]]


def run_merkle_proof(tree_depth: int = 8, index: int = 42,
                     options: Optional[dict] = None, device="cuda"):
    """Returns (stark, proof, assertions, public inputs)."""
    stark, assertions, inputs, public = merkle_proof_case(tree_depth, index, options, device)
    return stark, stark.prove(assertions, inputs), assertions, public


def merkle_update_case(tree_depth: int = 8, index: int = 42, old_value: int = 9,
                       new_value: int = 11, options: Optional[dict] = None, device="cuda"):
    """(stark, assertions, inputs) of a proof that a leaf update links the
    two roots (merkleUpdate.ts:60-101)."""
    field, oracle = poseidon_oracle("224")
    stark = instantiate_script(MERKLE_UPDATE_SRC, options or dict(OPTIONS), device)
    leaves1 = field.prng(b"\x51", 2 ** tree_depth)
    leaves1[index] = old_value
    tree1 = MerkleTree2(leaves1, oracle)
    branch1 = tree1.prove(index)
    leaves2 = list(leaves1)
    leaves2[index] = new_value
    tree2 = MerkleTree2(leaves2, oracle)
    branch2 = tree2.prove(index)
    bits = [0] + to_binary_array(index, tree_depth)[:-1]
    inputs = [[branch1[0]], [branch2[0]], [branch1[1:]], [bits]]
    T = STEPS * tree_depth
    assertions = [Assertion(step=T - 1, register=0, value=tree1.root),
                  Assertion(step=T - 1, register=6, value=tree2.root)]
    return stark, assertions, inputs


def run_merkle_update(tree_depth: int = 8, index: int = 42, old_value: int = 9,
                      new_value: int = 11, options: Optional[dict] = None, device="cuda"):
    """Returns (stark, proof, assertions)."""
    stark, assertions, inputs = merkle_update_case(tree_depth, index, old_value,
                                                   new_value, options, device)
    return stark, stark.prove(assertions, inputs), assertions


if __name__ == "__main__":
    import sys
    depth = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    dev = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    stark, proof, assertions, public = run_merkle_proof(depth, 5, device=dev)
    assert stark.verify(assertions, stark.parse(stark.serialize(proof)), public)
    print(f"merkle proof (import): {stark.size_of(proof)} bytes")
    stark, proof, assertions = run_merkle_update(depth, 5, device=dev)
    assert stark.verify(assertions, stark.parse(stark.serialize(proof)))
    print(f"merkle update (import): {stark.size_of(proof)} bytes")
