"""Final FRI-input linear combination L(x).

Counterpart of ``genstark_tpu/protocol/lincomb.py``: the degree
bookkeeping, the coefficient offset (:27) and the verifier's point
evaluation `compute_one` (:50).  The prover combines on the device
(protocol/lincomb_kernel.py) with the same coefficients, drawn through
`composition.transcript_coefficients`.
"""

from __future__ import annotations

from typing import List, Optional

from .composition import transcript_coefficients


class LinearCombination:
    def __init__(self, composition_degree: int, context, seed: Optional[bytes] = None,
                 coefficient_offset: int = 0):
        self.field = context.field
        self.seed = seed
        self.coefficient_offset = coefficient_offset
        self.ps_incremental_degree = composition_degree - context.trace_length
        self._coefficients = None

    def _get_coefficients(self, count: int) -> List[int]:
        if self._coefficients is None:
            _, self._coefficients = transcript_coefficients(
                self.field, self.seed, (self.coefficient_offset, count))
        return self._coefficients

    def compute_one(self, x: int, d_value: int, p_values: List[int],
                    s_values: List[int]) -> int:
        f = self.field.host
        ps = list(p_values) + list(s_values)
        ps2 = []
        if self.ps_incremental_degree > 0:
            power = f.exp(x, self.ps_incremental_degree)
            ps2 = [f.mul(v, power) for v in ps]
        all_values = ps + ps2
        coefficients = self._get_coefficients(len(all_values))
        acc = 0
        for v, c in zip(all_values, coefficients):
            acc = f.add(acc, f.mul(v, c))
        return f.add(d_value, acc)
