"""Elliptic-curve point multiplication STARK on the PyTorch port: the
config of examples/elliptic.py (the reference's examples/elliptic/pointMul.ts
with pointmul.aa) with the same source, options and oracle, importing only
genstark_tpu_torch: double-and-add over secp224r1's base field (p = 2^224 -
2^96 + 1), 8 registers x 256 steps, the scalar fed LSB-first as a rank-2 bit
input.  The AirAssembly source is the port's generated stdlib
(`pointmul_source`); its transition divides by registers (host work, in
the trace), its constraints do not (so a prove runs no `inv`).

The oracle is plain affine secp224r1 arithmetic (a = -3), which reproduces
the coordinates the reference hard-codes (pointMul.ts:30-33).

    python -m examples.elliptic_torch [device]
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from genstark_tpu_torch import instantiate
from genstark_tpu_torch.field import P224
from genstark_tpu_torch.protocol import Assertion
from genstark_tpu_torch.stdlib import pointmul_source

DEFAULT_OPTIONS = {                     # pointMul.ts:11-17
    "hash_algorithm": "blake2s256",
    "extension_factor": 16,
    "exe_query_count": 48,
    "fri_query_count": 24,
}

# pointMul.ts:24-33
G_X = 19277929113566293071110308034699488026831934219452440156649784352033
G_Y = 19926808758034470970197974370888749184205991990603949537637343198772
SCALAR = 21628546220445634706341881427918508772248629391536891476641575405363
EXPECTED = (5326626235735428056996404471396244610891648579045949976641038973984,
            6753729428472267765045584530315486521937702623726344079323769311058)

A = -3   # secp224r1 short-Weierstrass a


def ec_add(p1: Optional[Tuple[int, int]], p2: Optional[Tuple[int, int]],
           p: int = P224) -> Optional[Tuple[int, int]]:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2) % p == 0:
        return None
    if p1 == p2:
        slope = (3 * x1 * x1 + A) * pow(2 * y1, p - 2, p) % p
    else:
        slope = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
    x3 = (slope * slope - x1 - x2) % p
    y3 = (slope * (x1 - x3) - y1) % p
    return (x3, y3)


def ec_mul(point: Tuple[int, int], scalar: int, p: int = P224):
    """Double-and-add (LSB first), the computation pointmul.aa proves."""
    result, addend = None, point
    while scalar:
        if scalar & 1:
            result = ec_add(result, addend, p)
        addend = ec_add(addend, addend, p)
        scalar >>= 1
    return result


def to_bits(value: int, length: int = 256) -> List[int]:
    """LSB-first 256-bit decomposition (pointMul.ts:65-68)."""
    return [(value >> i) & 1 for i in range(length)]


def make_pointmul_stark(options: Optional[dict] = None, device="cuda"):
    return instantiate(pointmul_source(), "default", options or dict(DEFAULT_OPTIONS),
                       device=device)


def pointmul_case(options: Optional[dict] = None, device="cuda"):
    """(stark, assertions, inputs) of the reference's point multiplication."""
    stark = make_pointmul_stark(options, device)
    expected = ec_mul((G_X, G_Y), SCALAR)
    assert expected == EXPECTED          # oracle matches pointMul.ts:30-33
    inputs = [[G_X], [G_Y], [to_bits(SCALAR)]]
    assertions = [Assertion(step=255, register=2, value=expected[0]),
                  Assertion(step=255, register=3, value=expected[1])]
    return stark, assertions, inputs


def run(options: Optional[dict] = None, device="cuda"):
    """Returns (stark, proof, assertions)."""
    stark, assertions, inputs = pointmul_case(options, device)
    return stark, stark.prove(assertions, inputs), assertions


if __name__ == "__main__":
    import sys
    stark, proof, assertions = run(device=sys.argv[1] if len(sys.argv) > 1 else "cuda")
    buf = stark.serialize(proof)
    assert len(buf) == stark.size_of(proof)
    assert stark.verify(assertions, stark.parse(buf))
    print(f"pointmul: proof {len(buf)} bytes, security {stark.security_level}")
