"""Fibonacci STARK on the PyTorch port — the AIR of examples/fibonacci.py
(the reference's demo/fibonacci.ts): 2 registers over p32, r0' = r0 + r1,
r1' = r0 + 2*r1 (two Fibonacci numbers a step), a secret input register
holding the start value, the default options; importing only
genstark_tpu_torch.

    python -m examples.fibonacci_torch [steps] [device] [staged]

proves `steps` (default 64) on `device` (default cuda) with `prove`, or
with `prove_staged` when a third argument `staged` is given, logging each
step, and verifies the proof.
"""

from __future__ import annotations

from genstark_tpu_torch import instantiate
from genstark_tpu_torch.air import AirSchema, InputRegister
from genstark_tpu_torch.air.ir import nxt, static, trace
from genstark_tpu_torch.field import P32, create_prime_field
from genstark_tpu_torch.protocol import Assertion

# expected results from the reference (fibonacci.ts:9-11)
EXPECTED = {2 ** 6: 1783540607, 2 ** 13: 203257732, 2 ** 17: 2391373091}


def make_fib_stark(steps: int, options: dict = None, logger=None, device="cuda"):
    field = create_prime_field(P32)
    schema = AirSchema(
        field=field,
        trace_width=2,
        static_registers=[InputRegister(secret=True)],
        init=[static(0), static(0)],
        transition=[trace(0) + trace(1), trace(0) + 2 * trace(1)],
        constraints=[nxt(0) - (trace(0) + trace(1)),
                     nxt(1) - (trace(0) + 2 * trace(1))],
        base_steps=steps,
        name="fibonacci",
    )
    return instantiate(schema, "default", options, logger, device=device)


def run_fibonacci(field, steps: int, start: int):
    a = b = start
    trace_rows = [(a, b)]
    for _ in range(steps - 1):
        a, b = field.add(a, b), field.add(a, field.mul(2, b))
        trace_rows.append((a, b))
    return trace_rows


def fib_case(steps: int, options: dict = None, logger=None, device="cuda"):
    """(stark, assertions, inputs) of the reference's run from start value
    1, the last value checked against the reference's where it has one."""
    stark = make_fib_stark(steps, options, logger, device)
    controls = run_fibonacci(stark.air.field, steps, 1)
    if steps in EXPECTED:
        assert controls[-1][1] == EXPECTED[steps], "oracle does not match reference"
    assertions = [Assertion(step=0, register=0, value=1),
                  Assertion(step=0, register=1, value=1),
                  Assertion(step=steps - 1, register=1, value=controls[-1][1])]
    return stark, assertions, [[1]]


def run(steps: int = 2 ** 6, options: dict = None, logger=None, device="cuda",
        staged: bool = False):
    stark, assertions, inputs = fib_case(steps, options, logger, device)
    prove = stark.prove_staged if staged else stark.prove
    proof = prove(assertions, inputs)
    buf = stark.serialize(proof)
    assert len(buf) == stark.size_of(proof)
    assert stark.verify(assertions, stark.parse(buf))
    return {"proof_bytes": len(buf), "security_level": stark.security_level}


if __name__ == "__main__":
    import json
    import sys
    from genstark_tpu_torch.utils import Logger
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2 ** 6
    dev = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    print(json.dumps(run(n, logger=Logger(), device=dev, staged=len(sys.argv) > 3)))
