"""Finite-field layer of the PyTorch port.

Counterpart of ``genstark_tpu/field/__init__.py``.  `PrimeField` is the
facade the protocol talks to: scalar and coefficient-form ops run on the
host (`HostField`, python ints).  Batch ops run on a torch device through
`DeviceField`, which is built for one explicit `torch.device` — the port
never picks a device by itself.
"""

from __future__ import annotations

from functools import lru_cache

from .device import DeviceField
from .host import HostField
from .limbs import MontParams

# Fields used by the reference's examples (the JAX package's constants)
P32 = 2**32 - 3 * 2**25 + 1        # README "Foo" demo, fibonacci
P64 = 2**64 - 21 * 2**30 + 1       # rescue hash2x64
P128 = 2**128 - 9 * 2**32 + 1      # mimc128, rescue 4x128, poseidon, assembly lib128
P224 = 2**224 - 2**96 + 1          # secp224r1 base field: pointmul, lib224
P256 = 2**256 - 351 * 2**32 + 1    # mimc256


class PrimeField:
    """A prime field: Montgomery parameters plus the host backend.  The
    element interchange type at API boundaries is python int (standard
    form); device arrays are int32[L, N] 16-bit limbs (see DeviceField)."""

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.params = MontParams(modulus)
        self.host = HostField(modulus)

    @property
    def element_size(self) -> int:
        return self.params.element_size

    def __repr__(self):
        return f"PrimeField({self.modulus})"

    # scalar ops delegate to host
    def add(self, a, b): return self.host.add(a, b)
    def exp(self, a, e): return self.host.exp(a, e)
    def inv(self, a): return self.host.inv(a)

    def prng(self, seed: bytes, count: int = None):
        return self.host.prng(seed, count)

    def get_root_of_unity(self, n: int) -> int:
        return self.host.get_root_of_unity(n)

    def device_field(self, device) -> DeviceField:
        """The batch backend of this field on one explicit torch device."""
        return DeviceField(self.params, device)


@lru_cache(maxsize=None)
def create_prime_field(modulus: int) -> PrimeField:
    """Create (and cache) a PrimeField for the given modulus."""
    return PrimeField(modulus)
