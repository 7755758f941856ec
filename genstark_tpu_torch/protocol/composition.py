"""Composition polynomial C(x) = D(x) + B(x).

Counterpart of ``genstark_tpu/protocol/composition.py``: the constructor
(:49-84; `seed=None` builds the structure only: degrees, constraint groups,
coefficient counts), the grouping helpers, the staged prover's
`evaluate_all` (:89-197) and the verifier's point evaluation `evaluate_at`
(:199).  The one-fetch prover evaluates C(x) on the device by its own
stages (protocol/prover.py and the tail kernel).  Both draw their coefficients
from one prng(e_root) stream: the verifier through
`transcript_coefficients` on the host, the prover through
`transcript_coefficients_dev` on the device (`fused.py:713-725`).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .boundary import BoundaryConstraints
from .fiat_shamir import prng_elements_dev
from .zeropoly import ZeroPolynomial


def get_combination_degree(constraint_degrees: List[int], trace_length: int) -> int:
    max_degree = max([1] + list(constraint_degrees))
    return (1 << (max_degree - 1).bit_length() if max_degree > 1 else 1) * trace_length


def group_transition_constraints(constraint_degrees: List[int], trace_length: int):
    """Group constraint indexes by degree*traceLength, insertion-ordered."""
    groups = {}
    for i, d in enumerate(constraint_degrees):
        groups.setdefault(d * trace_length, []).append(i)
    return [{"degree": degree, "indexes": idxs} for degree, idxs in groups.items()]


def transcript_coefficients(field, seed: bytes, counts: Sequence[int]) -> List[List[int]]:
    """Consecutive slices of the one coefficient stream field.prng(seed):
    the composition's d and b coefficients, then the linear combination's
    (whose offset is the composition's count).  Prover and verifier both
    draw through here."""
    stream = field.prng(seed, sum(counts))
    out, start = [], 0
    for n in counts:
        out.append(stream[start:start + n])
        start += n
    return out


def transcript_coefficients_dev(dev, seed_words, counts: Sequence[int]):
    """`transcript_coefficients` on the device: consecutive [L, n]
    Montgomery slices of the one stream prng_elements_dev(seed_words),
    seed_words the int32 [8] words of the seed digest."""
    stream = prng_elements_dev(dev, seed_words, sum(counts))
    out, start = [], 0
    for n in counts:
        out.append(stream[:, start:start + n])
        start += n
    return out


class CompositionPolynomial:
    def __init__(self, assertions, seed, context, logger=None):
        self.field = context.field
        self.log = logger or (lambda msg: None)
        self.b_poly = BoundaryConstraints(assertions, context)
        self.z_poly = ZeroPolynomial(context)

        degrees = context.constraint_degrees
        T = context.trace_length
        self.combination_degree = get_combination_degree(degrees, T)
        self.composition_degree = max(self.combination_degree - T, T)
        self.constraint_groups = group_transition_constraints(degrees, T)

        d_coefficient_count = len(degrees)
        for group in self.constraint_groups:
            if group["degree"] < self.combination_degree:
                d_coefficient_count += len(group["indexes"])
        b_coefficient_count = self.b_poly.count
        if self.composition_degree > T:
            b_coefficient_count *= 2
        self.d_coefficient_count = d_coefficient_count
        self.b_coefficient_count = b_coefficient_count

        if seed is not None:
            self.d_coefficients, self.b_coefficients = transcript_coefficients(
                self.field, seed, (d_coefficient_count, b_coefficient_count))
        else:
            self.d_coefficients = self.b_coefficients = None

    @property
    def coefficient_count(self) -> int:
        return self.d_coefficient_count + self.b_coefficient_count

    def evaluate_all(self, p_polys: torch.Tensor, p_evaluations: torch.Tensor,
                     context) -> torch.Tensor:
        """The staged prover's C(x) (JAX :89-197, its host-coefficient path):
        p_polys [R, L, T] trace polynomials (Montgomery); p_evaluations is
        not read (the JAX signature).  Returns C(x) evaluations [L, Ne],
        Montgomery.  Every table is a `power_series`, every transform the
        public `ntt`; each step logs the JAX message."""
        from .. import ntt
        field = self.field
        f = field.host
        dev = field.device_field(p_polys.device)
        Ne = context.evaluation_domain_size
        Nc = context.composition_domain_size

        q_evals = context.evaluate_transition_constraints(p_polys)      # [C, L, Nc]
        self.log("Computed transition constraint polynomials Q(x)")

        composition_rou = f.exp(context.root_of_unity, Ne // Nc)
        qa = [q_evals[i] for i in range(q_evals.shape[0])]
        for group in self.constraint_groups:
            if group["degree"] == self.combination_degree:
                continue
            powers = dev.power_series(
                f.exp(composition_rou, self.combination_degree - group["degree"]), Nc)
            for i in group["indexes"]:
                qa.append(dev.mul(qa[i], powers))
        self.log("Adjusted degrees of Q(x) polynomials")

        qc = dev.combine_many(qa, self.d_coefficients)                    # [L, Nc]
        self.log("Computed linear combination of Q(x) polynomials")

        qe = ntt.low_degree_extend(field, ntt.intt(field, qc), Ne)         # [L, Ne]
        self.log("Performed low degree extensions of Q(x) polynomial")

        domain = dev.power_series(context.root_of_unity, Ne)
        self.log("Computed Z(x) polynomial")
        z_inverses = self.z_poly.evaluate_all_inverse(domain)
        self.log("Computed Z(x) inverses")
        d_evals = dev.mul(qe, z_inverses)
        self.log("Computed D(x) polynomial")

        ba = list(self.b_poly.evaluate_all(p_polys, Ne))
        self.log("Computed boundary constraint polynomials B(x)")

        b_incremental = self.composition_degree - context.trace_length
        if b_incremental > 0:
            psb_powers = dev.power_series(f.exp(context.root_of_unity, b_incremental), Ne)
            for i in range(self.b_poly.count):
                ba.append(dev.mul(ba[i], psb_powers))
        self.log("Adjusted degrees of B(x) polynomials")

        bc = dev.combine_many(ba, self.b_coefficients) if ba else dev.zeros((Ne,))
        self.log("Computed linear combination of B(x) polynomials")
        return dev.add(d_evals, bc)

    def evaluate_at(self, x: int, p_values: List[int], n_values: List[int],
                    s_values: List[int], context, invs) -> int:
        """invs: (1/Z(x), the boundary 1/Z_b(x)) for this x, which the
        verifier batches across query positions."""
        f = self.field.host
        q_values = context.evaluate_constraints_at(x, p_values, n_values, s_values)

        for group in self.constraint_groups:
            if group["degree"] == self.combination_degree:
                continue
            power = f.exp(x, self.combination_degree - group["degree"])
            for i in group["indexes"]:
                q_values.append(f.mul(q_values[i], power))

        qc = 0
        for v, c in zip(q_values, self.d_coefficients):
            qc = f.add(qc, f.mul(v, c))

        z_inv, b_z_invs = invs
        d_value = f.mul(qc, z_inv)

        b_values = self.b_poly.evaluate_at(p_values, x, b_z_invs)
        b_incremental = self.composition_degree - context.trace_length
        if b_incremental > 0:
            power = f.exp(x, b_incremental)
            for i in range(self.b_poly.count):
                b_values.append(f.mul(b_values[i], power))

        b_value = 0
        for v, c in zip(b_values, self.b_coefficients):
            b_value = f.add(b_value, f.mul(v, c))

        return f.add(d_value, b_value)
