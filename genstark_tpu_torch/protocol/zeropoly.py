"""Transition vanishing polynomial Z(x) = (x^T - 1)/(x - x_last).

Counterpart of ``genstark_tpu/protocol/zeropoly.py`` (constructor, the
verifier's point evaluation `evaluate_at` as `inverse_at` on a batched
inverse, and the periodic inverse numerator the prover's tail uses).
"""

from __future__ import annotations

from typing import List


class ZeroPolynomial:
    def __init__(self, context):
        self.context = context
        self.field = context.field
        T = context.trace_length
        ext = context.extension_factor
        self.trace_length = T
        self.x_at_last_step = self.field.exp(context.root_of_unity, (T - 1) * ext)

    def inverse_at(self, x: int, numerator_inv: int) -> int:
        """1/Z(x) = (x - x_last) / (x^T - 1) from 1/(x^T - 1), which the
        verifier batches across query positions."""
        f = self.field.host
        return f.mul(f.sub(x, self.x_at_last_step), numerator_inv)

    def inverse_numerators(self) -> List[int]:
        """1/(x^T - 1) over one period of the evaluation domain, as
        standard-form ints (with 1/0 := 0 at trace positions): x^T is
        ext-periodic over the domain, so `ext` values tile all of it."""
        f = self.field.host
        ctx = self.context
        w_t = self.field.exp(ctx.root_of_unity, self.trace_length)
        base = [f.sub(f.exp(w_t, j), 1) for j in range(ctx.extension_factor)]
        return [f.inv(v) if v else 0 for v in base]
