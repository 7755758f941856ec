"""The Stark orchestrator of the port: option checks, security level,
prove, serialize, parse, verify and size.

Counterpart of ``genstark_tpu/protocol/stark.py`` (:34-129, `verify`
:270-362, `parse` :364, `_parse_values` :399).  `prove` runs the host trace
and the device prover (protocol/prover.py) on the Stark's torch device.
`verify` runs on the host alone, as the JAX package's does: it needs no
device tensor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..hash import HASH_ALGORITHMS, create_hash
from ..merkle import MerkleTree
from ..utils import pow_log2
from .composition import CompositionPolynomial
from .fri import LowDegreeVerifier, StarkError, rehashed
from .lincomb import LinearCombination
from .proof import StarkProof
from .prover import Prover
from .queries import QueryIndexGenerator
from .serializer import Serializer
from .sizeof import size_of

DEFAULT_EXE_QUERY_COUNT = 80
DEFAULT_FRI_QUERY_COUNT = 40
MAX_EXE_QUERY_COUNT = 128
MAX_FRI_QUERY_COUNT = 64
DEFAULT_HASH_ALGORITHM = "sha256"


@dataclass
class Assertion:
    """Boundary assertion: trace[register][step] == value."""
    step: int
    register: int
    value: int


class Stark:
    def __init__(self, air, device, options: Optional[dict] = None):
        options = options or {}
        self.air = air
        self.dev = air.field.device_field(device)

        exe_query_count = options.get("exe_query_count") or DEFAULT_EXE_QUERY_COUNT
        if not (1 <= exe_query_count <= MAX_EXE_QUERY_COUNT):
            raise ValueError(
                f"Execution sample size must be an integer between 1 and {MAX_EXE_QUERY_COUNT}")
        fri_query_count = options.get("fri_query_count") or DEFAULT_FRI_QUERY_COUNT
        if not (1 <= fri_query_count <= MAX_FRI_QUERY_COUNT):
            raise ValueError(
                f"FRI sample size must be an integer between 1 and {MAX_FRI_QUERY_COUNT}")
        hash_algorithm = options.get("hash_algorithm") or DEFAULT_HASH_ALGORITHM
        if hash_algorithm not in HASH_ALGORITHMS:
            raise ValueError(f"Hash algorithm {hash_algorithm} is not supported")

        self.hash = create_hash(hash_algorithm)
        self.index_generator = QueryIndexGenerator(
            air.extension_factor, exe_query_count, fri_query_count)
        self.serializer = Serializer(air.field, air.trace_register_count,
                                     air.secret_input_count, self.hash.digest_size)
        self._provers = {}
        self.last_context = None

    @property
    def security_level(self) -> int:
        ext = self.air.extension_factor
        es = pow_log2(ext / self.air.max_constraint_degree,
                      self.index_generator.exe_query_count)
        fs = math.log2(ext) * self.index_generator.fri_query_count
        hs = self.hash.digest_size * 4
        return int(min(es, fs, hs))

    def prove(self, assertions: Sequence[Assertion], inputs: Optional[Sequence] = None,
              seed: Optional[Sequence[int]] = None) -> StarkProof:
        if not assertions:
            raise TypeError("At least one assertion must be provided")
        context = self.air.init_proving_context(inputs, seed)
        self.last_context = context      # its trace_source and trace_seconds
        try:
            trace_std = context.generate_execution_trace_std()
            self._validate_assertions(context, trace_std, assertions)
        except StarkError:
            raise
        except Exception as error:
            raise StarkError("Failed to generate the execution trace") from error
        return self._prover(context, assertions).prove(trace_std)

    def verify(self, assertions: Sequence[Assertion], proof: StarkProof,
               public_inputs: Optional[Sequence] = None) -> bool:
        """True, or raises StarkError (or the error of a malformed proof)."""
        if not assertions:
            raise TypeError("At least one assertion must be provided")
        f = self.air.field.host

        # 1 ----- context
        e_root = proof.ev_root
        ext = self.air.extension_factor
        context = self.air.init_verification_context(proof.i_shapes, public_inputs)
        evaluation_domain_size = context.trace_length * ext
        c_poly = CompositionPolynomial(assertions, e_root, context)
        l_combination = LinearCombination(c_poly.composition_degree, context, seed=e_root,
                                          coefficient_offset=c_poly.coefficient_count)

        # 2 ----- spot-check positions
        positions = self.index_generator.get_exe_indexes(
            proof.ld_proof.lc_root, evaluation_domain_size)
        augmented_positions = self.index_generator.get_augmented_positions(
            positions, evaluation_domain_size)

        # 3 ----- decode evaluation spot-checks
        p_evaluations: Dict[int, List[int]] = {}
        s_evaluations: Dict[int, List[int]] = {}
        for i, merged in enumerate(proof.ev_proof.values):
            position = augmented_positions[i]
            p_evaluations[position], s_evaluations[position] = self._parse_values(merged)

        # 4 ----- verify evaluation merkle proof
        if not MerkleTree.verify_batch(e_root, augmented_positions,
                                       rehashed(proof.ev_proof, self.hash), self.hash):
            raise StarkError("Verification of evaluation Merkle proof failed")

        # 5 ----- constraint checks + linear combination values; every
        # per-position inversion (Z(x) through (x^T - 1), and each boundary
        # Z_b(x)) batches into one Montgomery-trick inversion
        T = context.trace_length
        z = c_poly.z_poly
        xs = [f.exp(context.root_of_unity, step) for step in positions]
        n_b = c_poly.b_poly.count
        dens = []
        for x in xs:
            dens.append(f.sub(f.exp(x, T), 1))
            dens.extend(c_poly.b_poly.z_dens_at(x))
        invs = f.batch_inv(dens)
        lc_values = []
        for i, step in enumerate(positions):
            x = xs[i]
            p_values = p_evaluations[step]
            n_values = p_evaluations[(step + ext) % evaluation_domain_size]
            s_values = s_evaluations[step]
            base = i * (1 + n_b)
            z_inv = z.inverse_at(x, invs[base])
            c_value = c_poly.evaluate_at(x, p_values, n_values, s_values, context,
                                         invs=(z_inv, invs[base + 1:base + 1 + n_b]))
            lc_values.append(l_combination.compute_one(x, c_value, p_values, s_values))

        # 6 ----- low-degree proof
        LowDegreeVerifier(self.index_generator, self.hash, context).verify(
            proof.ld_proof, lc_values, positions, c_poly.composition_degree)
        return True

    def parse(self, buf: bytes) -> StarkProof:
        return self.serializer.parse_proof(buf)

    def _parse_values(self, buf: bytes):
        """One evaluation leaf -> (trace register values, secret register
        values)."""
        elem = self.air.field.element_size
        ints = [int.from_bytes(buf[i * elem:(i + 1) * elem], "little")
                for i in range(self.air.trace_register_count + self.air.secret_input_count)]
        return ints[:self.air.trace_register_count], ints[self.air.trace_register_count:]

    def _prover(self, context, assertions) -> Prover:
        """Provers (device tables and DFT plans) are cached per context
        shape and assertion values."""
        key = (context.trace_length, tuple(tuple(s) for s in context.input_shapes),
               tuple((a.step, a.register, a.value) for a in assertions))
        prover = self._provers.get(key)
        if prover is None:
            prover = Prover(self, context, assertions, self.dev)
            self._provers[key] = prover
        else:
            prover.context = context
        return prover

    def _validate_assertions(self, context, trace_std, assertions) -> None:
        registers, _, steps = trace_std.shape
        for a in assertions:
            if a.register < 0 or a.register >= registers:
                raise ValueError(
                    f"Invalid assertion: register {a.register} is outside of register bank")
            if a.step < 0 or a.step >= steps:
                raise ValueError(
                    f"Invalid assertion: step {a.step} is outside of execution trace")
            if context.trace_value_host(a.register, a.step) != a.value % self.air.field.modulus:
                raise StarkError(
                    f"Assertion at step {a.step}, register {a.register} "
                    f"conflicts with execution trace")

    def size_of(self, proof: StarkProof) -> int:
        return size_of(proof, self.air.field.element_size, self.hash.digest_size)["total"]

    def serialize(self, proof: StarkProof) -> bytes:
        return self.serializer.serialize_proof(proof)
