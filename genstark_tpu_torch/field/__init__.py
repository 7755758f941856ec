"""Finite-field layer of the PyTorch port.

Counterpart of ``genstark_tpu/field/__init__.py`` (`PrimeField` :26-90).
`PrimeField` is the facade the protocol talks to: scalar and
coefficient-form ops run on the host (`HostField`, python ints).  Batch ops
run on a torch device through `DeviceField`, one per explicit
`torch.device` (`device_field`, memoized, so a tensor's device names its
DeviceField).  `PrimeField.device`, the JAX package's one DeviceField, is
the CUDA card's: where there is no card it raises, and a CPU caller asks
for `device_field("cpu")`.
"""

from __future__ import annotations

import secrets
from functools import lru_cache

import torch

from .device import DeviceField
from .host import HostField
from .limbs import MontParams, element_size_for, limb_count_for  # noqa: F401  (re-exported)

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
        self._device_fields = {}

    @property
    def element_size(self) -> int:
        return self.params.element_size

    @property
    def characteristic(self) -> int:
        return self.modulus

    @property
    def is_optimized(self) -> bool:
        return True  # the kernels take every modulus of the repo

    @property
    def device(self) -> DeviceField:
        """The JAX package's `PrimeField.device` (field/__init__.py:37): the
        DeviceField of the CUDA card, `device_field("cuda")`."""
        return self.device_field("cuda")

    @property
    def one(self) -> int:
        return 1

    @property
    def zero(self) -> int:
        return 0

    def __repr__(self):
        return f"PrimeField({self.modulus})"

    # scalar ops delegate to host
    def add(self, a, b): return self.host.add(a, b)
    def sub(self, a, b): return self.host.sub(a, b)
    def mul(self, a, b): return self.host.mul(a, b)
    def div(self, a, b): return self.host.div(a, b)
    def neg(self, a): return self.host.neg(a)
    def exp(self, a, e): return self.host.exp(a, e)
    def inv(self, a): return self.host.inv(a)

    def rand(self) -> int:
        return secrets.randbelow(self.modulus)

    def prng(self, seed: bytes, count: int = None):
        return self.host.prng(seed, count)

    def get_root_of_unity(self, n: int) -> int:
        return self.host.get_root_of_unity(n)

    def get_power_series(self, seed: int, length: int):
        return self.host.get_power_series(seed, length)

    # one element as little-endian bytes (the proof's wire format)
    def to_bytes(self, value: int) -> bytes:
        return int(value).to_bytes(self.element_size, "little")

    def from_bytes(self, data: bytes) -> int:
        return int.from_bytes(data, "little")

    def device_field(self, device) -> DeviceField:
        """The batch backend of this field on one explicit torch device, one
        per device (a CUDA device without an index is the current one, so
        `"cuda"` and a tensor's `cuda:0` share it, and its constants)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        dev = self._device_fields.get(device)
        if dev is None:
            dev = self._device_fields[device] = DeviceField(self.params, device=device)
        return dev


@lru_cache(maxsize=None)
def create_prime_field(modulus: int) -> PrimeField:
    """Create (and cache) a PrimeField for the given modulus."""
    return PrimeField(modulus)
