"""The Stark orchestrator of the port: option checks, security level, prove,
serialize and size.

Counterpart of ``genstark_tpu/protocol/stark.py`` (:34-129).  `prove` runs
the host trace and the device prover (protocol/prover.py) on the Stark's
torch device.  `parse` and `verify` are not ported: the JAX package's
verifier checks the port's proof bytes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..hash import HASH_ALGORITHMS, create_hash
from ..utils import pow_log2
from .fri import StarkError
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
        try:
            trace_std = context.generate_execution_trace_std()
            self._validate_assertions(context, trace_std, assertions)
        except StarkError:
            raise
        except Exception as error:
            raise StarkError("Failed to generate the execution trace") from error
        return self._prover(context, assertions).prove(trace_std)

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

    def get_augmented_positions(self, positions: List[int], domain_size: int) -> List[int]:
        """pos and (pos + ext) mod N, insertion-ordered dedup."""
        skip = self.air.extension_factor
        out = dict()
        for p in positions:
            out[p] = True
            out[(p + skip) % domain_size] = True
        return list(out.keys())

    def size_of(self, proof: StarkProof) -> int:
        return size_of(proof, self.air.field.element_size, self.hash.digest_size)["total"]

    def serialize(self, proof: StarkProof) -> bytes:
        return self.serializer.serialize_proof(proof)
