"""Static-variables demo on the PyTorch port — the AIR of
examples/demo_static.py (the reference's demo/staticVariables.ts): field
96769 (16-bit limbs, L = 2, 2-adicity 9: the radix-2 route), two cyclic
static registers k0 (period 4) and k1 (period 8), v' = v + 1 + k0 + 2*k1,
64 steps, expected result 780; importing only genstark_tpu_torch.

    python -m examples.demo_static_torch [steps] [device] [staged]

proves on `device` (default cuda) with `prove`, or `prove_staged` when a
third argument `staged` is given, logging each step, and verifies.
"""

from __future__ import annotations

from genstark_tpu_torch import instantiate
from genstark_tpu_torch.air import AirSchema, CyclicRegister, InputRegister
from genstark_tpu_torch.air.ir import nxt, static, trace
from genstark_tpu_torch.field import create_prime_field
from genstark_tpu_torch.protocol import Assertion

MODULUS = 96769
EXPECTED_RESULT = 780


def make_demo_stark(steps: int = 64, options: dict = None, logger=None, device="cuda"):
    field = create_prime_field(MODULUS)
    schema = AirSchema(
        field=field,
        trace_width=1,
        static_registers=[CyclicRegister([1, 2, 3, 4]),
                          CyclicRegister([1, 2, 3, 4, 5, 6, 7, 8]),
                          InputRegister(secret=True)],
        init=[static(2)],
        transition=[trace(0) + 1 + static(0) + 2 * static(1)],
        constraints=[nxt(0) - (trace(0) + 1 + static(0) + 2 * static(1))],
        base_steps=steps,
        name="demo",
    )
    return instantiate(schema, "default", options, logger, device=device)


def run_demo(field, steps: int, start: int):
    k0 = [1, 2, 3, 4]
    k1 = [1, 2, 3, 4, 5, 6, 7, 8]
    vals = [start]
    for i in range(steps - 1):
        vals.append(field.add(vals[i], 1 + k0[i % 4] + 2 * k1[i % 8]))
    return vals


def demo_case(steps: int = 64, options: dict = None, logger=None, device="cuda"):
    """(stark, assertions, inputs) of the reference's run from 1, the last
    value checked against the reference's at 64 steps."""
    stark = make_demo_stark(steps, options, logger, device)
    controls = run_demo(stark.air.field, steps, 1)
    if steps == 64:
        assert controls[-1] == EXPECTED_RESULT, "oracle mismatch vs reference table"
    assertions = [Assertion(step=0, register=0, value=1),
                  Assertion(step=steps - 1, register=0, value=controls[-1])]
    return stark, assertions, [[1]]


def run(steps: int = 64, options: dict = None, logger=None, device="cuda",
        staged: bool = False):
    stark, assertions, inputs = demo_case(steps, options, logger, device)
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
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    dev = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    print(json.dumps(run(n, logger=Logger(), device=dev, staged=len(sys.argv) > 3)))
