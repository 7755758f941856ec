"""Composition polynomial C(x) = D(x) + B(x): structure only.

Counterpart of the constructor and grouping helpers of
``genstark_tpu/protocol/composition.py`` (:23-85).  The prover evaluates
C(x) on the device with transcript coefficients (protocol/prover.py and
the tail kernel); this class carries the degrees, the constraint groups and
the coefficient counts.
"""

from __future__ import annotations

from typing import List

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


class CompositionPolynomial:
    def __init__(self, assertions, context):
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

    @property
    def coefficient_count(self) -> int:
        return self.d_coefficient_count + self.b_coefficient_count
