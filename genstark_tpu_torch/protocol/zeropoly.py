"""Transition vanishing polynomial Z(x) = (x^T - 1)/(x - x_last).

Counterpart of ``genstark_tpu/protocol/zeropoly.py``: the constructor,
the point evaluation `evaluate_at` (:25; the verifier's is `inverse_at`,
on a batched inverse), the staged prover's `evaluate_all` and
`evaluate_all_inverse` over the evaluation domain (:31-71), and the
periodic inverse numerator the one-fetch prover's tail uses.
"""

from __future__ import annotations

from typing import List

import torch


class ZeroPolynomial:
    def __init__(self, context):
        self.context = context
        self.field = context.field
        T = context.trace_length
        ext = context.extension_factor
        self.trace_length = T
        self.x_at_last_step = self.field.exp(context.root_of_unity, (T - 1) * ext)

    def evaluate_at(self, x: int) -> int:
        f = self.field.host
        num = f.sub(f.exp(x, self.trace_length), 1)
        den = f.sub(x, self.x_at_last_step)
        return f.div(num, den)

    def evaluate_all(self, domain: torch.Tensor):
        """domain: [L, Ne] Montgomery powers of the evaluation domain's root.
        Returns (numerators x^T - 1, denominators x - x_last), [L, Ne]
        Montgomery each; x^T is ext-periodic over the domain, so the
        numerators are one period's power series of w^T tiled."""
        ctx = self.context
        dev = self.field.device_field(domain.device)
        Ne = ctx.evaluation_domain_size
        ext = ctx.extension_factor
        w_t = self.field.exp(ctx.root_of_unity, self.trace_length)
        x_to_t = dev.power_series(w_t, ext).repeat(1, Ne // ext)
        numerators = dev.sub(x_to_t, dev.one((1,)))
        denominators = dev.sub(domain, dev.const(self.x_at_last_step, shape=(1,)))
        return numerators, denominators

    def evaluate_all_inverse(self, domain: torch.Tensor) -> torch.Tensor:
        """1/Z(x) over the evaluation domain, [L, Ne] Montgomery (1/0 := 0
        at the trace positions): the `ext` inverse numerators
        (`inverse_numerators`) tiled, times the denominators."""
        ctx = self.context
        dev = self.field.device_field(domain.device)
        Ne = ctx.evaluation_domain_size
        inv_numerators = dev.from_ints(self.inverse_numerators()).repeat(
            1, Ne // ctx.extension_factor)
        denominators = dev.sub(domain, dev.const(self.x_at_last_step, shape=(1,)))
        return dev.mul(denominators, inv_numerators)

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
