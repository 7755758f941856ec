"""MiMC STARK on the PyTorch port — the same AIR as examples/mimc.py
(x' = x^3 + k, 64 cyclic round constants, blake2s256, ext=16, exe=48,
fri=24; the 128-bit field by default, or any field of the port such as
P256, the reference's mimc256), importing only genstark_tpu_torch.

    python -m examples.mimc_torch [steps] [device] [modulus name]

e.g. `python -m examples.mimc_torch 8192 cuda P256`.
"""

from __future__ import annotations

from genstark_tpu_torch import instantiate
from genstark_tpu_torch.air import AirSchema, CyclicRegister, InputRegister
from genstark_tpu_torch.air.ir import nxt, seed, static, trace
from genstark_tpu_torch import field as fields
from genstark_tpu_torch.field import P128, create_prime_field
from genstark_tpu_torch.protocol import Assertion

MIMC_SEED = bytes.fromhex("4d694d43")   # 'MiMC'


def round_constants(field, count: int = 64):
    """Cyclic round constants from the sha256-counter PRNG."""
    return field.prng(MIMC_SEED, count)


def run_mimc(field, steps: int, constants, seed_value: int):
    """Control values of the recurrence (the assertion oracle)."""
    result = [seed_value % field.modulus]
    for i in range(steps - 1):
        result.append(field.add(field.exp(result[i], 3), constants[i % len(constants)]))
    return result


def make_mimc_stark(steps: int, device, modulus: int = P128, use_input: bool = True,
                    constant_count: int = 64, options: dict = None):
    field = create_prime_field(modulus)
    constants = round_constants(field, constant_count)
    statics = [CyclicRegister(constants)]
    if use_input:
        statics.append(InputRegister(secret=True))
        init = [static(1)]
    else:
        init = [seed(0)]
    schema = AirSchema(
        field=field,
        trace_width=1,
        static_registers=statics,
        init=init,
        transition=[trace(0) ** 3 + static(0)],
        constraints=[nxt(0) - (trace(0) ** 3 + static(0))],
        base_steps=steps,
        name="mimc",
    )
    default_options = {"hash_algorithm": "blake2s256", "extension_factor": 16,
                       "exe_query_count": 48, "fri_query_count": 24}
    default_options.update(options or {})
    return instantiate(schema, default_options, device), constants


def prove_mimc(steps: int, device, seed_value: int = 3, **kwargs):
    """Prove one MiMC run (secret-input variant by default); returns
    (stark, proof bytes)."""
    use_input = kwargs.get("use_input", True)
    stark, constants = make_mimc_stark(steps, device, **kwargs)
    field = stark.air.field
    controls = run_mimc(field, steps, constants, seed_value)
    assertions = [Assertion(0, 0, controls[0]), Assertion(steps - 1, 0, controls[-1])]
    if use_input:
        proof = stark.prove(assertions, [[seed_value]])
    else:
        proof = stark.prove(assertions, [], [seed_value])
    return stark, stark.serialize(proof)


if __name__ == "__main__":
    import hashlib
    import sys
    from genstark_tpu_torch.utils import Logger
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2 ** 13
    dev = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    name = sys.argv[3].upper() if len(sys.argv) > 3 else "P128"
    modulus = getattr(fields, name)
    log = Logger().start(f"MiMC over {name}, {n} steps, on {dev}")
    _, data = prove_mimc(n, dev, modulus=modulus)
    log(f"proof {len(data)} bytes, sha256 {hashlib.sha256(data).hexdigest()}")
