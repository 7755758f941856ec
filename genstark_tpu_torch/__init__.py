"""genstark_tpu_torch — the STARK prover of genstark_tpu on PyTorch and CUDA.

The port of the JAX package ``genstark_tpu`` to one NVIDIA Hopper GPU.  It
imports torch and numpy only: never jax, never genstark_tpu.  Host-only code
(limb codecs, host field, AIR IR, query sampling, proof codec) is carried as
trimmed copies; the kernels the prover reaches are hand-written CUDA for
sm_90a in ``csrc/`` (see kernels.py).

- `instantiate(schema, options, device)` builds a Stark from an AirSchema on
  one explicit torch device; `air.convert.schema_from_reference` rebuilds a
  schema made with the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from .air import AirModule, AirSchema
from .field import create_prime_field
from .protocol import Assertion, Stark, StarkError, StarkProof

__version__ = "0.1.0"


def instantiate(schema: AirSchema, options: Optional[dict], device) -> Stark:
    """A Stark for `schema` whose tensors all live on `device` (a
    torch.device or its name; nothing is picked by default)."""
    options = options or {}
    air = AirModule(schema, extension_factor=options.get("extension_factor"))
    return Stark(air, torch.device(device), options)


__all__ = ["AirSchema", "Assertion", "Stark", "StarkError", "StarkProof",
           "create_prime_field", "instantiate"]
