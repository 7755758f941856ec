"""Final FRI-input linear combination L(x): structure only.

Counterpart of ``genstark_tpu/protocol/lincomb.py``.  The prover combines
on the device (protocol/lincomb_kernel.py) with coefficients drawn from the
transcript; this class carries the degree bookkeeping.
"""

from __future__ import annotations


class LinearCombination:
    def __init__(self, composition_degree: int, context):
        self.ps_incremental_degree = composition_degree - context.trace_length
