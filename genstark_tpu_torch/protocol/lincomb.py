"""Final FRI-input linear combination L(x).

Counterpart of ``genstark_tpu/protocol/lincomb.py``: the degree
bookkeeping, the coefficient offset (:27), the staged prover's
`compute_many` (:33-48) and the verifier's point evaluation `compute_one`
(:50).  The one-fetch prover combines on the device
(protocol/lincomb_kernel.py) with the same coefficients, drawn through
`composition.transcript_coefficients`.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .composition import transcript_coefficients


class LinearCombination:
    def __init__(self, composition_degree: int, context, seed: Optional[bytes] = None,
                 coefficient_offset: int = 0):
        self.field = context.field
        self.seed = seed
        self.coefficient_offset = coefficient_offset
        self.ps_incremental_degree = composition_degree - context.trace_length
        self.root_of_unity = context.root_of_unity
        self.domain_size = context.trace_length * context.extension_factor
        self._coefficients = None

    def _get_coefficients(self, count: int) -> List[int]:
        if self._coefficients is None:
            _, self._coefficients = transcript_coefficients(
                self.field, self.seed, (self.coefficient_offset, count))
        return self._coefficients

    def compute_many(self, c_evaluations: torch.Tensor, p_evaluations: torch.Tensor,
                     s_evaluations: List[torch.Tensor]) -> torch.Tensor:
        """The staged prover's L(x) (JAX :33-48): c [L, Ne], p [R, L, Ne], s a
        list of [L, Ne], all Montgomery; returns [L, Ne] Montgomery."""
        dev = self.field.device_field(c_evaluations.device)
        f = self.field.host
        ps = [p_evaluations[r] for r in range(p_evaluations.shape[0])] + list(s_evaluations)
        ps2 = []
        if self.ps_incremental_degree > 0:
            ps_powers = dev.power_series(
                f.exp(self.root_of_unity, self.ps_incremental_degree), self.domain_size)
            ps2 = [dev.mul(v, ps_powers) for v in ps]
        all_evals = ps + ps2
        combination = dev.combine_many(all_evals, self._get_coefficients(len(all_evals)))
        return dev.add(c_evaluations, combination)

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
