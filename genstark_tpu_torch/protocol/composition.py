"""Composition polynomial C(x) = D(x) + B(x).

Counterpart of ``genstark_tpu/protocol/composition.py``: the constructor
(:49-84; `seed=None` builds the structure only: degrees, constraint groups,
coefficient counts), the grouping helpers and the verifier's point
evaluation `evaluate_at` (:199).  The prover evaluates C(x) on the device
(protocol/prover.py and the tail kernel).  Both draw their coefficients
from one prng(e_root) stream through `transcript_coefficients`.
"""

from __future__ import annotations

from typing import List, Sequence

from .boundary import BoundaryConstraints
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


class CompositionPolynomial:
    def __init__(self, assertions, seed, context):
        self.field = context.field
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
