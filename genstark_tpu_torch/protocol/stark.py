"""The Stark orchestrator of the port: option checks, security level,
prove, prove_staged, serialize, parse, verify and size.

Counterpart of ``genstark_tpu/protocol/stark.py`` (:34-129, `prove_staged`
:187-268, `verify` :270-362, `generate_execution_trace` :352, `parse` :364,
`_merge_values` :379, `_parse_values` :399, `_validate_assertions` :412).
`prove` runs the host trace and the one-fetch device prover
(protocol/prover.py) on the Stark's torch device; `prove_staged` runs the
stage classes one by one there, with the transcript on the host.
`verify` runs on the host alone, as the JAX package's does: it needs no
device tensor.  With a mesh (option "mesh" or `set_mesh`, :75-87) `prove`
runs the sharded prover (protocol/sharded.py) on every rank of it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import ntt, tracing
from ..field.limbs import limbs_to_ints
from ..hash import HASH_ALGORITHMS, create_hash
from ..merkle import MerkleTree
from ..utils import Logger, noop_logger, pow_log2
from .composition import CompositionPolynomial
from .fri import LowDegreeProver, LowDegreeVerifier, StarkError, rehashed
from .lincomb import LinearCombination
from .proof import StarkProof
from .prover import Prover
from .queries import QueryIndexGenerator
from .serializer import Serializer
from .sharded import ShardedProver
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
    def __init__(self, air, options: Optional[dict] = None,
                 logger: Optional[Logger] = None, *, device="cuda"):
        options = options or {}
        self.air = air
        self.dev = air.field.device_field(device)
        self.logger = logger or noop_logger

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
        self.mesh = None
        self.set_mesh(options.get("mesh"))

    def set_mesh(self, mesh) -> None:
        """Shard `prove` over a parallel.mesh.Mesh (every rank of it calls
        prove with the same inputs and gets the same proof), or go back to
        one device with None (the JAX `set_mesh`, stark.py:83-87).  The
        Stark's tensors move to the mesh's device."""
        if mesh is not self.mesh:
            self.mesh = mesh
            self._provers = {}
            if mesh is not None:
                self.dev = self.air.field.device_field(mesh.device)

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
        """The one-fetch prover (protocol/prover.py); logs the JAX `prove`'s
        lines (stark.py:108-128).  A `tracing` root span, `stark.prove`."""
        with tracing.span("stark.prove"):
            log = self.logger.start("Starting STARK computation")
            if not assertions:
                raise TypeError("At least one assertion must be provided")
            with tracing.span("stark.context"):
                context = self.air.init_proving_context(inputs, seed, dev=self.dev)
            self.last_context = context      # its trace_source and trace_seconds
            log("Set up evaluation context")
            try:
                trace_std = context.generate_execution_trace_std()
                with tracing.span("stark.assertions"):
                    self._validate_assertions(context, trace_std, assertions)
            except StarkError:
                raise
            except Exception as error:
                raise StarkError("Failed to generate the execution trace") from error
            log("Generated execution trace")
            with tracing.span("stark.prover"):
                prover = self._prover(context, assertions)
            proof = prover.prove(trace_std)
            log("Computed STARK proof (fused single-program pipeline)")
            self.logger.done(log, "STARK computed")
            return proof

    def prove_staged(self, assertions: Sequence[Assertion],
                     inputs: Optional[Sequence] = None,
                     seed: Optional[Sequence[int]] = None) -> StarkProof:
        """The stage-by-stage prover (JAX `prove_staged`, stark.py:187-268):
        each stage through its own class on the Stark's device, Montgomery
        form from the trace to `LowDegreeProver.prove`, the transcript on
        the host (every tree's root is fetched), a log line a step.  Its
        bytes are the one-fetch prove's."""
        log = self.logger.start("Starting STARK computation")
        if not assertions:
            raise TypeError("At least one assertion must be provided")
        field = self.air.field
        dev = self.dev

        # 1 ----- evaluation context
        context = self.air.init_proving_context(inputs, seed, dev=dev)
        self.last_context = context
        evaluation_domain_size = context.evaluation_domain_size
        log("Set up evaluation context")

        # 2 ----- execution trace
        try:
            execution_trace = context.generate_execution_trace()     # [R, L, T]
            self._validate_assertions_device(execution_trace, assertions)
        except StarkError:
            raise
        except Exception as error:
            raise StarkError("Failed to generate the execution trace") from error
        log("Generated execution trace")

        # 3 ----- P(x) polynomials + low-degree extension
        p_polys = ntt.intt(field, execution_trace)                   # [R, L, T]
        log("Computed execution trace polynomials P(x)")
        p_evaluations = ntt.low_degree_extend(field, p_polys, evaluation_domain_size)
        log("Low-degree extended P(x) polynomials over evaluation domain")

        # 4 ----- evaluation merkle tree over P and S rows
        s_evaluations = context.secret_register_traces               # list [L, Ne]
        e_std = torch.stack([dev.from_mont(p_evaluations[r])
                             for r in range(p_evaluations.shape[0])]
                            + [dev.from_mont(s) for s in s_evaluations])   # [V, L, Ne]
        hashed_evaluations = self.hash.merge_element_rows(e_std, field.element_size)
        log("Serialized evaluations of P(x) and S(x) polynomials")
        e_tree = MerkleTree.create(hashed_evaluations, self.hash)
        log("Built evaluation merkle tree")

        # 5 ----- composition polynomial C(x)
        c_logger = self.logger.sub("Computing composition polynomial")
        c_poly = CompositionPolynomial(assertions, e_tree.root, context, c_logger)
        c_evaluations = c_poly.evaluate_all(p_polys, p_evaluations, context)
        self.logger.done(c_logger)
        log("Computed composition polynomial C(x)")

        # 6 ----- random linear combination
        l_combination = LinearCombination(e_tree.root, c_poly.composition_degree,
                                          c_poly.coefficient_count, context)
        l_evaluations = l_combination.compute_many(c_evaluations, p_evaluations,
                                                   s_evaluations)
        log("Combined P(x) and S(x) evaluations with C(x) evaluations")

        # 7 ----- low-degree proof
        try:
            ld_logger = self.logger.sub("Computing low degree proof")
            ld_prover = LowDegreeProver(self.index_generator, self.hash, context, ld_logger)
            ld_proof = ld_prover.prove(l_evaluations, c_poly.composition_degree)
            self.logger.done(ld_logger)
            log("Computed low-degree proof")
        except StarkError:
            raise
        except Exception as error:
            raise StarkError("Low degree proof failed") from error

        # 8 ----- evaluation tree spot checks
        positions = self.index_generator.get_exe_indexes(ld_proof.lc_root,
                                                         evaluation_domain_size)
        augmented_positions = self.index_generator.get_augmented_positions(
            positions, evaluation_domain_size)
        e_values = self._merge_values(e_std, augmented_positions)
        e_proof = e_tree.prove_batch(augmented_positions)
        e_proof.values = e_values
        log(f"Computed {len(positions)} evaluation spot checks")
        self.logger.done(log, "STARK computed")
        return StarkProof(ev_root=e_tree.root, ev_proof=e_proof, ld_proof=ld_proof,
                          i_shapes=context.input_shapes)

    def generate_execution_trace(self, inputs=None, seed=None):
        """(the Montgomery [R, L, T] trace on the Stark's device, its
        proving context)."""
        context = self.air.init_proving_context(inputs, seed, dev=self.dev)
        return context.generate_execution_trace(), context

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
        l_combination = LinearCombination(e_root, c_poly.composition_degree,
                                          c_poly.coefficient_count, context)

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
        shape and assertion structure, the JAX `_fused_prover`'s key
        (stark.py:131-152): statements that assert other values at the same
        steps and registers share one.  A Prover is built from the
        structure alone, every value zero: its boundary quotients read only
        the asserted steps (`BoundaryConstraints.evaluate_all_tables`)."""
        structure = tuple((a.step, a.register) for a in assertions)
        key = (context.trace_length, tuple(tuple(s) for s in context.input_shapes), structure)
        prover = self._provers.get(key)
        if prover is None:
            points = [Assertion(step, register, 0) for step, register in structure]
            with tracing.span("prover.new"):
                prover = (Prover(self, context, points, self.dev) if self.mesh is None else
                          ShardedProver(self, context, points, self.dev, self.mesh))
            self._provers[key] = prover
        else:
            prover.context = context
        return prover

    def _validate_assertions(self, context, trace_std, assertions) -> None:
        registers, _, steps = trace_std.shape
        for a in assertions:
            self._check_assertion_ranges(registers, steps, [a])
            if context.trace_value_host(a.register, a.step) != a.value % self.air.field.modulus:
                raise StarkError(
                    f"Assertion at step {a.step}, register {a.register} "
                    f"conflicts with execution trace")

    def _check_assertion_ranges(self, registers: int, steps: int, assertions) -> None:
        for a in assertions:
            if a.register < 0 or a.register >= registers:
                raise ValueError(
                    f"Invalid assertion: register {a.register} is outside of register bank")
            if a.step < 0 or a.step >= steps:
                raise ValueError(
                    f"Invalid assertion: step {a.step} is outside of execution trace")

    def _validate_assertions_device(self, trace: torch.Tensor, assertions) -> None:
        """The JAX `_validate_assertions` (stark.py:412-431) on a Montgomery
        [R, L, T] device trace: the asserted points in one gather and one
        fetch."""
        registers, _, steps = trace.shape
        self._check_assertion_ranges(registers, steps, assertions)
        idx = tracing.upload([[a.register, a.step] for a in assertions], torch.int64,
                             trace.device)
        cols = trace[idx[:, 0], :, idx[:, 1]].T                      # [L, A]
        values = self.dev.to_ints(cols.contiguous())
        for a, v in zip(assertions, values):
            if v != a.value % self.air.field.modulus:
                raise StarkError(
                    f"Assertion at step {a.step}, register {a.register} "
                    f"conflicts with execution trace")

    def _merge_values(self, vectors_std: torch.Tensor, positions: List[int]) -> List[bytes]:
        """Leaf bytes at positions, each the concatenation of every vector's
        element (JAX stark.py:379-396): vectors_std [V, L, Ne] standard
        form, all positions in one gather and one fetch."""
        elem = self.air.field.element_size
        V, L, _ = vectors_std.shape
        idx = tracing.upload(positions, torch.int64, vectors_std.device)
        picked = tracing.fetch(vectors_std.index_select(2, idx)).numpy().astype(np.uint32)
        ints = limbs_to_ints(np.moveaxis(picked, 1, 0).reshape(L, -1))   # v-major
        n = len(positions)
        return [b"".join(ints[v * n + i].to_bytes(elem, "little") for v in range(V))
                for i in range(n)]

    def size_of(self, proof: StarkProof) -> int:
        return size_of(proof, self.air.field.element_size, self.hash.digest_size)["total"]

    def serialize(self, proof: StarkProof) -> bytes:
        """The proof's bytes; a `tracing` root span, `stark.serialize`."""
        with tracing.span("stark.serialize"):
            return self.serializer.serialize_proof(proof)
